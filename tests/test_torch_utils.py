"""The port's ``utils/profiling.py`` and ``utils/debug.py`` on the CPU,
against the JAX package's where both can run the same thing: time_fn's
keys, the trace file, NaN checks raising FloatingPointError at the
operator that makes the NaN, debug_mode restoring the previous state, the
compiled paths' eager switch, and assert_finite's message (exact, against
the JAX function's on the same tree)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.utils import debug as tdebug
from multi_modal_transformers_tokenmerge_torch.utils import profiling as tprof
from multi_modal_transformers_tokenmerge_tpu.utils import debug as jdebug
from multi_modal_transformers_tokenmerge_tpu.utils import profiling as jprof


@pytest.fixture(autouse=True)
def _debug_off():
    """Every test starts and ends with the checks off."""
    tdebug.enable_debug_checks(nans=False)
    tdebug._STATE["disable_jit"] = False
    yield
    tdebug.enable_debug_checks(nans=False)
    tdebug._STATE["disable_jit"] = False


def test_time_fn_keys_match_jax():
    x = torch.ones(16)
    got = tprof.time_fn(lambda: (x * 2, {"y": [x + 1]}), iters=5, warmup=1)
    want = jprof.time_fn(lambda: jnp.ones(16) * 2, iters=5, warmup=1)
    assert sorted(got) == sorted(want) == ["iters", "mean", "p50", "p90",
                                           "p99"]
    assert got["iters"] == 5
    assert 0 <= got["p50"] <= got["p90"] <= got["p99"]
    assert all(isinstance(got[k], float) for k in ("p50", "p90", "p99",
                                                   "mean"))


def test_time_fn_runs_warmup_and_iters():
    calls = []
    tprof.time_fn(lambda a, b=0: calls.append((a, b)), 1, iters=4,
                  warmup=2, b=3)
    assert calls == [(1, 3)] * 6


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_nan_checks_raise_like_jax():
    """The same NaN-making operation raises FloatingPointError under
    debug_mode in both packages; finite work passes."""
    with jdebug.debug_mode():
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray(-1.0))
    with tdebug.debug_mode():
        assert torch.log(torch.tensor(2.0)) > 0
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.tensor(-1.0))
        torch.empty(1000)                     # allocators are not checked
    assert torch.isnan(torch.log(torch.tensor(-1.0)))     # off again


def test_nan_check_catches_a_model_forward_and_its_backward():
    from multi_modal_transformers_tokenmerge_torch.modules.layers import Dense
    layer = Dense(4, 3, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.ones(2, 4)
    tdebug.enable_debug_checks(nans=True)
    layer(x)                                  # finite: passes
    with torch.no_grad(), pytest.raises(FloatingPointError, match="fill"):
        layer.weight[0, 0].fill_(float("nan"))   # writing a NaN is caught
    tdebug.enable_debug_checks(nans=False)
    with torch.no_grad():
        layer.weight[0, 0] = float("nan")
    tdebug.enable_debug_checks(nans=True)
    with pytest.raises(FloatingPointError, match="nan"):
        layer(x)
    tdebug.enable_debug_checks(nans=False)
    # forward finite, backward 0 * d sqrt(y)/dy at 0 = 0 * inf = nan
    y = torch.tensor([0.0, 1.0], requires_grad=True)
    with tdebug.debug_mode(disable_jit=False):
        out = (torch.sqrt(y) * 0.0).sum()
        with pytest.raises(FloatingPointError):
            out.backward()


def test_debug_mode_restores_previous_state():
    assert tdebug.jit_enabled() and not tdebug.nan_checks_enabled()
    with tdebug.debug_mode():
        assert tdebug.nan_checks_enabled() and not tdebug.jit_enabled()
        with tdebug.debug_mode(nans=False, disable_jit=False):
            assert tdebug.jit_enabled()
        assert tdebug.nan_checks_enabled() and not tdebug.jit_enabled()
    assert tdebug.jit_enabled() and not tdebug.nan_checks_enabled()
    tdebug.enable_debug_checks(nans=True)
    with tdebug.debug_mode(nans=False, disable_jit=True):
        assert not tdebug.nan_checks_enabled()
    assert tdebug.nan_checks_enabled()        # as before the block
    # JAX restores its two flags the same way
    prev = (jax.config.jax_debug_nans, jax.config.jax_disable_jit)
    with jdebug.debug_mode():
        pass
    assert (jax.config.jax_debug_nans, jax.config.jax_disable_jit) == prev


def test_enable_debug_checks_disable_jit_only_turns_on():
    tdebug.enable_debug_checks(nans=False, disable_jit=True)
    assert not tdebug.jit_enabled()
    tdebug.enable_debug_checks(nans=False, disable_jit=False)
    assert not tdebug.jit_enabled()           # as jax_disable_jit stays on


def test_compiled_paths_read_the_debug_gate():
    from multi_modal_transformers_tokenmerge_torch.serve import policy
    from multi_modal_transformers_tokenmerge_torch.train import steps
    assert policy.jit_enabled is tdebug.jit_enabled
    assert steps.jit_enabled is tdebug.jit_enabled


@pytest.mark.parametrize("head", ["diffusion", "continuous"])
def test_serving_under_nan_checks(head):
    """A whole compiled-engine request and a train step of a micro model
    run under debug_mode without a false alarm (every operator checked),
    and give the unchecked results bit for bit."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine)
    from multi_modal_transformers_tokenmerge_torch.train.optim import (
        make_optimizer)
    from multi_modal_transformers_tokenmerge_torch.train.state import (
        create_train_state)
    from multi_modal_transformers_tokenmerge_torch.train.steps import (
        make_train_step)
    from torch_parity import inputs, octo_micro_t5, to_torch_config
    cfg = to_torch_config(octo_micro_t5())
    ids, images = inputs(octo_micro_t5(), batch=2, seed=1)
    out = {}
    for checked in (False, True):
        model = Octo(cfg, device="cpu", seed=0)
        eng = PolicyEngine(model, head=head, batch_size=2, seed=1).compile(
            (cfg.text.max_length,), images.shape[1:])
        state = create_train_state(
            Octo(cfg, device="cpu", seed=0),
            make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=10),
            rngs=0)
        step = make_train_step(head, jit=True)
        actions = np.zeros((2, cfg.heads.diffusion.action_space_dim
                            if head == "diffusion" else 4), np.float32)
        with tdebug.debug_mode(nans=checked, disable_jit=checked):
            eng.set_instruction(ids)
            act = eng(images)
            _, loss = step(state, torch.from_numpy(ids).long(),
                           torch.from_numpy(images), torch.from_numpy(actions))
        out[checked] = (act, loss)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tree", [
    {"a": np.array([1.0, np.nan, np.inf, np.inf])},
    {"params": {"dense": {"kernel": np.array([[np.nan, 0.0]]),
                          "bias": np.zeros(2)}}},
    [np.zeros(2), {"x": np.array([-np.inf])}],
])
def test_assert_finite_message_matches_jax(tree):
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite(tree, "state")
    with pytest.raises(FloatingPointError) as got:
        tdebug.assert_finite(jax.tree.map(torch.tensor, tree), "state")
    assert str(got.value) == str(want.value)


def test_assert_finite_modules_and_state_dicts():
    from multi_modal_transformers_tokenmerge_torch.modules.layers import Dense
    layer = Dense(2, 2, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  device="cpu")
    with torch.no_grad():
        layer.weight.fill_(1.0)
        layer.bias.fill_(0.0)
    tdebug.assert_finite(layer)
    tdebug.assert_finite({"ok": torch.arange(3), "n": None})
    with torch.no_grad():
        layer.weight[1] = float("inf")
        layer.bias[0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"model\['weight'\]: nan=0, inf=2"):
        tdebug.assert_finite(layer, "model")
    with pytest.raises(FloatingPointError, match=r"\['bias'\]: nan=1, inf=0"):
        tdebug.assert_finite({"weight": layer.weight.detach().clone().fill_(0),
                              "bias": layer.bias}, "sd")
