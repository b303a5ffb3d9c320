"""The port's continuous and categorical action heads against the JAX
package's, on the CPU in float32: the heads alone on random readouts (mean
and MAP pooling), ``assign_bins``, and the losses built on them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_configs import octo_micro
from torch_parity import MODULE_TOL, assert_close, micro_pair
from multi_modal_transformers_tokenmerge_torch.heads import categorical as tcat
from multi_modal_transformers_tokenmerge_torch.train.optim import decay_mask
from multi_modal_transformers_tokenmerge_tpu.heads import categorical as jcat


def _cfg(pooling="mean", max_action=1.0):
    base = octo_micro(
        input_sequence="[TaskDescriptionPrefix{4}] [Image{4};Readout{2}]*2",
        num_observation_blocks=2)
    return base.replace(heads=base.heads.replace(
        continuous=base.heads.continuous.replace(pooling=pooling,
                                                 max_action=max_action,
                                                 map_num_heads=2)))


def _readouts(batch, tokens, seed):
    return np.random.default_rng(seed).normal(
        size=(batch, tokens, 32)).astype(np.float32)


@pytest.mark.parametrize("pooling,max_action", [("mean", 1.0), ("map", 1.0),
                                                ("map", 2.5), ("mean", 0.5)])
@pytest.mark.parametrize("batch,tokens", [(2, 2), (3, 8), (1, 4)])
def test_continuous_head_matches(pooling, max_action, batch, tokens):
    cfg = _cfg(pooling, max_action)
    jm, v, tm = micro_pair(cfg)
    r = _readouts(batch, tokens, seed=tokens)
    ref = jm.apply(v, jnp.asarray(r),
                   method=lambda m, x: m.continuous_action_head(x))
    with torch.no_grad():
        out = tm.continuous_action_head(torch.tensor(r))
    assert tuple(out.shape) == ref.shape == (batch, 1, 4)
    assert_close(out, ref, MODULE_TOL)
    assert out.abs().max() <= max_action


def test_map_pooling_parameters_convert_and_decay():
    """MAP pooling's cross_attention / learnt_q_input come across, and its
    q/k/v biases, (H, D) leaves in flax, decay like the optax mask says."""
    from multi_modal_transformers_tokenmerge_tpu.train.optim import (
        decay_mask as jmask)
    cfg = _cfg("map")
    _, v, tm = micro_pair(cfg)
    names = {n for n, _ in tm.named_parameters()
             if n.startswith("continuous_action_head.map_pooling")}
    assert {"continuous_action_head.map_pooling.learnt_q_input",
            "continuous_action_head.map_pooling.cross_attention.query.bias",
            "continuous_action_head.map_pooling.cross_attention.out.weight",
            "continuous_action_head.map_pooling.ln.weight",
            "continuous_action_head.map_pooling.mlp.dense_in.weight"
            } <= names
    flax = jmask(v["params"])["continuous_action_head"]["map_pooling"]
    got = decay_mask(tm)
    pre = "continuous_action_head.map_pooling."
    assert got[pre + "cross_attention.query.bias"] is True
    assert flax["cross_attention"]["query"]["bias"] is True
    assert got[pre + "cross_attention.out.bias"] is False
    assert flax["cross_attention"]["out"]["bias"] is False
    assert got[pre + "learnt_q_input"] is True
    assert flax["learnt_q_input"] is True
    assert got[pre + "ln.weight"] is False and flax["ln"]["scale"] is False


@pytest.mark.parametrize("batch,per_dim", [(2, 1), (3, 2), (1, 1), (1, 3)])
def test_categorical_head_matches(batch, per_dim):
    """(B, A*T, E) readouts -> logits; the JAX head squeezes every
    dimension of size 1 (batch 1 included), and so does the port."""
    cfg = _cfg()
    jm, v, tm = micro_pair(cfg)
    a = cfg.heads.categorical.action_space_dim
    r = _readouts(batch, a * per_dim, seed=batch + per_dim)
    ref = jm.apply(v, jnp.asarray(r),
                   method=lambda m, x: m.categorical_action_head(x))
    with torch.no_grad():
        out = tm.categorical_action_head(torch.tensor(r))
    want = (batch, a, 16) if batch > 1 else (a, 16)
    assert tuple(out.shape) == ref.shape == want
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("num_bins,bound", [(16, 1.0), (256, 1.0), (7, 2.0)])
def test_assign_bins_matches(num_bins, bound):
    rng = np.random.default_rng(num_bins)
    x = rng.uniform(-1.2 * bound, 1.2 * bound, (64, 3)).astype(np.float32)
    # the edges themselves, where both ends of the range are exact
    x[0] = [-bound, 0.0, bound]
    want = jcat.assign_bins(jnp.asarray(x), (-bound, bound), num_bins)
    got = tcat.assign_bins(torch.tensor(x), (-bound, bound), num_bins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() == 0 and got.max() == num_bins + 1
    with pytest.raises(NotImplementedError):
        tcat.assign_bins(torch.tensor(x), (-bound, bound), num_bins, "log")


def test_losses_from_readouts_match():
    """_l2_from_readouts and _ce_from_readouts: per-example values,
    out-of-range actions (which select no class) included."""
    cfg = _cfg()
    jm, v, tm = micro_pair(cfg)
    rng = np.random.default_rng(0)
    r = _readouts(3, 2, seed=9)
    a4 = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(r), jnp.asarray(a4),
                   method=lambda m, x, y: m._l2_from_readouts(x, y))
    out = tm._l2_from_readouts(torch.tensor(r), torch.tensor(a4))
    assert tuple(out.shape) == ref.shape == (3,)
    assert_close(out, ref, MODULE_TOL)
    a2 = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    a2[0] = [1.5, -1.5]
    ref = jm.apply(v, jnp.asarray(r), jnp.asarray(a2),
                   method=lambda m, x, y: m._ce_from_readouts(x, y))
    out = tm._ce_from_readouts(torch.tensor(r), torch.tensor(a2))
    assert tuple(out.shape) == ref.shape == (3, 2)
    assert_close(out, ref, MODULE_TOL)
    assert out[0, 0] == 0.0 and out[1, 0] > 0.0
