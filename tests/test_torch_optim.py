"""The port's optimizer with its step count on the device, against optax.

The learning rate and Adam's bias corrections are computed on the device
from the optimizer's int32 ``count`` (so that a captured step replays every
later update correctly); they are held against optax's
``warmup_cosine_decay_schedule`` and ``adamw`` at every step through the
warmup and the decay, and ``skip_nonfinite_steps`` against
``optax.apply_if_finite`` over gradients with planted NaNs and infs.  All on
the CPU in float32.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.train import optim as toptim
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_tpu.train import optim as joptim

HYPER_RTOL = 1e-6      # schedule and corrections, float32
PARAM_RTOL = 1e-6      # parameters after each update, float32
PARAM_ATOL = 1e-7

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def _params(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=s).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(seed, plant=None):
    rng = np.random.default_rng(seed)
    g = {n: (rng.normal(size=s) * 0.3).astype(np.float32)
         for n, s in SHAPES.items()}
    if plant is not None:
        g["b"][2] = plant
    return g


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5), (4, 12)])
def test_hyperparameters_match_optax(warmup, total):
    """lr, 1 - b1^(n+1) and 1 - b2^(n+1) of update n, computed on the
    device from the int32 count, against optax's schedule and bias
    corrections at every n through warmup and decay (and past the end)."""
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    tx = toptim.make_optimizer(**kw)
    tx.init({"a": torch.zeros(2)}.items())
    assert tx.count.dtype == torch.int32 and int(tx.count) == 0
    ref = joptim.warmup_cosine_schedule(3e-4, warmup, total)
    for n in range(total + 3):
        lr, bc1, bc2 = tx.hyperparameters(torch.tensor(n, dtype=torch.int32))
        assert lr.dtype == torch.float32
        want = np.float32(ref(np.int32(n)))
        np.testing.assert_allclose(float(lr), want, rtol=HYPER_RTOL,
                                   atol=1e-12)
        for got, b in ((bc1, 0.9), (bc2, 0.999)):
            np.testing.assert_allclose(
                float(got), 1.0 - np.float32(b) ** np.float32(n + 1),
                rtol=HYPER_RTOL)


@pytest.mark.parametrize("clip", [1.0, None])
def test_updates_match_optax_through_warmup_and_decay(clip):
    """Twelve updates of make_optimizer against the optax chain of the JAX
    package's make_optimizer (warmup 3 of 10 steps, so the last updates sit
    at the end value): the parameters after every update, and the count."""
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=10,
              weight_decay=0.1, clip_norm=clip)
    jtx = joptim.make_optimizer(**kw)
    ttx = toptim.make_optimizer(**kw)
    jparams = _params(0)
    params = {n: torch.tensor(v) for n, v in jparams.items()}
    ttx.init(params.items())
    jstate = jtx.init(jparams)
    for i in range(12):
        g = _grads(10 + i)
        updates, jstate = jtx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.step(params, {n: torch.tensor(v) for n, v in g.items()})
        for n, v in jparams.items():
            np.testing.assert_allclose(params[n].numpy(), np.asarray(v),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert int(ttx.count) == 12


def _adam_state(state):
    return next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("max_bad", [1, 2])
def test_skip_nonfinite_matches_apply_if_finite(max_bad):
    """skip_nonfinite_steps=n against optax.apply_if_finite(tx, n) over a
    run with NaN and inf gradients planted in it, among them runs of bad
    updates longer than n (optax then applies the update): parameters,
    moments, the Adam count and the three skip counters after every
    update."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, clip_norm=1.0,
              skip_nonfinite_steps=max_bad)
    plants = [None, np.nan, None, np.inf, -np.inf, None, np.nan, np.nan,
              np.nan, None]
    jtx = joptim.make_optimizer(**kw)
    ttx = toptim.make_optimizer(**kw)
    jparams = _params(1)
    params = {n: torch.tensor(v) for n, v in jparams.items()}
    ttx.init(params.items())
    jstate = jtx.init(jparams)
    for i, plant in enumerate(plants):
        g = _grads(20 + i, plant)
        updates, jstate = jtx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.step(params, {n: torch.tensor(v) for n, v in g.items()})
        assert int(ttx.notfinite_count) == int(jstate.notfinite_count)
        assert int(ttx.total_notfinite) == int(jstate.total_notfinite)
        assert bool(ttx.last_finite) == bool(jstate.last_finite)
        adam = _adam_state(jstate)
        assert int(ttx.count) == int(adam.count), i
        for n, v in jparams.items():
            np.testing.assert_allclose(params[n].numpy(), np.asarray(v),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       equal_nan=True)
        for ours, theirs in ((ttx.mu, adam.mu), (ttx.nu, adam.nu)):
            for n, t in zip(ttx.names, ours):
                np.testing.assert_allclose(t.numpy(), np.asarray(theirs[n]),
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           equal_nan=True)
    # the run applied some bad updates (past max_bad in a row) and skipped
    # others
    assert int(ttx.total_notfinite) == sum(p is not None for p in plants)
    assert np.isnan(params["b"].numpy()).any()


def test_skipped_update_leaves_state_untouched():
    """One bad update after good ones: parameters, moments and count are
    bit for bit what they were."""
    tx = toptim.make_optimizer(peak_lr=1e-2, warmup_steps=0, total_steps=4,
                               skip_nonfinite_steps=3)
    params = {n: torch.tensor(v) for n, v in _params(2).items()}
    tx.init(params.items())
    tx.step(params, {n: torch.tensor(v) for n, v in _grads(3).items()})
    before = [t.clone() for t in (*params.values(), *tx.mu, *tx.nu,
                                  tx.count)]
    tx.step(params, {n: torch.tensor(v)
                     for n, v in _grads(4, np.inf).items()})
    after = (*params.values(), *tx.mu, *tx.nu, tx.count)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(tx.notfinite_count) == 1 and not bool(tx.last_finite)


def test_metrics_accumulate_in_place_on_the_device_counts():
    """The sums and counts are float32 tensors updated in place (a captured
    step keeps writing to them); averages divide by each metric's own
    count."""
    m = tstate.Metrics.empty(loss="avg", tokens="sum")
    sums, counts = dict(m.sums), dict(m.counts)
    m.update(loss=torch.tensor(2.0), tokens=3.0).update(loss=4.0)
    assert all(m.sums[n] is sums[n] and m.counts[n] is counts[n]
               for n in sums)
    assert {n: float(c) for n, c in m.counts.items()} == {"loss": 2.0,
                                                          "tokens": 1.0}
    out = m.compute()
    assert {k: float(v) for k, v in out.items()} == {"loss": 3.0,
                                                     "tokens": 3.0}
    m.update(tokens=1.0)
    assert float(out["tokens"]) == 3.0      # compute() returned a copy
