"""``evaluate`` in the port against the JAX package's, on the CPU.

Both run the micro T5 Octo on the same converted weights in eval mode (no
dropout, midpoint patch positions).  The diffusion loss still draws a
timestep and noise per batch: the same numpy draws are handed to both (the
JAX ``jax.random`` calls are replaced for the call, run without jit so that
each batch takes its own; the port's head gets them as arguments).  The
losses agree to LOSS_RTOL.  Apart from the JAX package: two calls agree,
the batch index changes the draws, and the training generators do not
advance.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import inputs, micro_pair, octo_micro_t5
from multi_modal_transformers_tokenmerge_torch import evaluate
from multi_modal_transformers_tokenmerge_torch.heads.diffusion import (
    DiffusionActionHead)
from multi_modal_transformers_tokenmerge_torch.train import optim as toptim
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_tpu.train import loop as jloop
from multi_modal_transformers_tokenmerge_tpu.train import state as jstate

LOSS_RTOL = 1e-5
HEAD_DIMS = {"diffusion": 4, "continuous": 4, "categorical": 2}


def _batches(cfg, head, n, seed):
    out = []
    for i in range(n):
        ids, images = inputs(cfg, batch=2, seed=seed + i)
        actions = np.random.default_rng(seed + 100 + i).uniform(
            -1, 1, (2, HEAD_DIMS[head])).astype(np.float32)
        out.append((ids, images, actions))
    return out


def _draws(cfg, n, seed):
    rng = np.random.default_rng(seed)
    d = cfg.heads.diffusion
    return [(rng.integers(0, d.diffusion_steps, (2, 1)).astype(np.int32),
             rng.normal(size=(2, d.action_space_dim)).astype(np.float32))
            for _ in range(n)]


def _port_state(model, seed=0):
    tx = toptim.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=4,
                               params=model)
    return tstate.create_train_state(model, tx, rngs=seed)


@pytest.mark.parametrize("head", sorted(HEAD_DIMS))
def test_evaluate_matches_jax(monkeypatch, head):
    cfg = octo_micro_t5()
    jm, v, model = micro_pair(cfg)
    batches = _batches(cfg, head, 3, seed=40)
    draws = _draws(cfg, 3, seed=41)
    key = jax.random.PRNGKey(0)
    js = jstate.create_train_state(
        jm, v, optax.sgd(0.1),
        rngs={"dropout": key, "patch_encoding": key, "diffusion": key})
    if head == "diffusion":
        times = collections.deque(t for t, _ in draws)
        noises = collections.deque(n for _, n in draws)
        monkeypatch.setattr(jax.random, "randint",
                            lambda k, shape, *a, **kw: jnp.asarray(
                                times.popleft()))
        monkeypatch.setattr(jax.random, "normal",
                            lambda k, shape=(), *a, **kw: jnp.asarray(
                                noises.popleft()))
    with jax.disable_jit():
        want = jloop.evaluate(js, iter(batches), head, 3)
    monkeypatch.undo()
    if head == "diffusion":
        assert not times and not noises
        queue = collections.deque(draws)
        original = DiffusionActionHead.denoise_loss

        def denoise_loss(self, readouts, actions, train=True, time=None,
                         noise=None, **kw):
            t, n = queue.popleft()
            return original(self, readouts, actions, train,
                            torch.tensor(t), torch.tensor(n), **kw)

        monkeypatch.setattr(DiffusionActionHead, "denoise_loss",
                            denoise_loss)
    got = evaluate(_port_state(model), iter(batches), head, 3)
    assert set(got) == {"loss"}
    np.testing.assert_allclose(got["loss"], float(want["loss"]),
                               rtol=LOSS_RTOL)


def test_evaluate_is_deterministic_and_leaves_training_generators():
    """Two calls on the same batches agree exactly; the training
    generators are where they were; batch 1 draws other numbers than
    batch 0 (the same batch twice averages to another loss than once)."""
    cfg = octo_micro_t5()
    model = micro_pair(cfg)[2]
    state = _port_state(model, seed=5)
    before = {n: g.get_state() for n, g in state.rngs.items()}
    batch = _batches(cfg, "diffusion", 1, seed=50)[0]
    a = evaluate(state, iter([batch, batch]), "diffusion", 2)
    b = evaluate(state, iter([batch, batch]), "diffusion", 2)
    assert a == b
    assert all(torch.equal(g.get_state(), before[n])
               for n, g in state.rngs.items())
    once = evaluate(state, iter([batch]), "diffusion", 1)
    assert once["loss"] != a["loss"]
    # another state with other generator seeds draws otherwise
    other = evaluate(_port_state(model, seed=6), iter([batch, batch]),
                     "diffusion", 2)
    assert other["loss"] != a["loss"]
