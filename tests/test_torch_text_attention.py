"""T5 text tower and the transformer stack of the port against the JAX
package, f32, tolerance 2e-5.  The stack runs under the micro layout's
block-causal mask with 'features' and 'sequence_compat' LayerNorms, with
and without the final norm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.modules import t5 as tt5
from multi_modal_transformers_tokenmerge_tpu.modules import t5 as jt5
from torch_parity import MODULE_TOL, assert_close, flat_intermediates, \
    inputs, micro_pair, octo_micro_t5


@pytest.mark.parametrize("t,buckets,dist", [(16, 32, 128), (40, 8, 20)])
def test_relative_position_bucket_matches(t, buckets, dist):
    pos = np.arange(t)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(
        tt5.relative_position_bucket(rel, buckets, dist),
        jt5.relative_position_bucket(rel, buckets, dist))


@pytest.mark.parametrize("kind", ["t5", "embed"])
def test_text_encoder_matches(kind):
    base = octo_micro_t5()
    cfg = base.replace(text=base.text.replace(kind=kind))
    jm, v, tm = micro_pair(cfg)
    ids, _ = inputs(cfg)
    ref = jm.apply(v, jnp.asarray(ids), method="encode_text")
    with torch.no_grad():
        out = tm.encode_text(torch.from_numpy(ids).long())
    assert tuple(out.shape) == ref.shape == (2, 4, 32)
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("final_norm", [False, True])
@pytest.mark.parametrize("reduction", ["features", "sequence_compat"])
def test_transformer_stack_matches(reduction, final_norm):
    base = octo_micro_t5()
    cfg = base.replace(transformer=base.transformer.replace(
        layer_norm_reduction=reduction, final_norm=final_norm))
    jm, v, tm = micro_pair(cfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    mask = jnp.asarray(tm.layout.attention_mask())
    ref = jm.apply(v, jnp.asarray(x),
                   method=lambda m, y: m.transformer(y, mask=mask,
                                                     deterministic=True))
    with torch.no_grad():
        out = tm.transformer(torch.from_numpy(x), tm.attention_mask)
    assert_close(out, ref, MODULE_TOL)


def test_readouts_match():
    """Assembly, transformer and readout gather from given modalities."""
    cfg = octo_micro_t5()
    jm, v, tm = micro_pair(cfg)
    rng = np.random.default_rng(3)
    text = rng.normal(size=(2, 4, 32)).astype(np.float32)
    img = rng.normal(size=(2, 8, 32)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(text), jnp.asarray(img),
                   method="generate_readouts_with_modalities")
    with torch.no_grad():
        out = tm.generate_readouts_with_modalities(torch.from_numpy(text),
                                                   torch.from_numpy(img))
    assert tuple(out.shape) == ref.shape == (2, 4, 32)
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("heads,block_q,block_k,compiled", [
    (12, 0, 0, True),      # head dim 64, its tiles
    (3, 32, 32, True),     # head dim 256, its tiles named
    (6, 0, 0, True),       # head dim 128, its tiles
    (8, 0, 0, True),       # head dim 96, padded to 128
    (2, 0, 0, False),      # head dim 384, on the wide kernels
    (12, 32, 32, False),   # head dim 64 with the TPU's tiles, not the card's
])
def test_auto_takes_the_kernel_only_where_it_is_compiled(
        monkeypatch, heads, block_q, block_k, compiled):
    """On a kernel device (monkeypatched here) 'auto' at flash_min_seq
    tokens takes the flash path at every head dim and every configured
    tile (``compiled``: the head dim and tiles of csrc/flash_attention.cu;
    the others run on the wide kernels or at the card's own tiles), and
    'flash' does too; the hook runs at kernel_tiles of its head dim."""
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        AttentionConfig, TransformerConfig)
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as tfa)
    monkeypatch.setattr(tattn, "kernel_device", lambda device: True)
    cfg = TransformerConfig(
        attention_impl="auto", flash_block_q=block_q, flash_block_k=block_k,
        attention=AttentionConfig(num_heads=heads, qkv_features=768,
                                  dropout_rate=0.0))
    seq = cfg.flash_min_seq
    mask = np.tril(np.ones((seq, seq), bool))
    d = 768 // heads
    assert ((block_q, block_k) in ((0, 0), tfa.kernel_tiles(d))
            and d <= 256) == compiled
    for impl in ("auto", "flash"):
        fn = tattn.select_attention_fn(cfg.replace(attention_impl=impl),
                                       mask, seq, "cpu")
        assert fn is not None
        assert fn.tables_for(d, "cpu")[:2] == tfa.kernel_tiles(d)


# -- every flax activation of the MLP block ----------------------------------

# the names the JAX MLPBlock resolves with getattr(flax.linen, name) and
# can apply (flax.linen.normalize is standardize's alias)
ACTIVATION_NAMES = (
    "relu", "gelu", "silu", "swish", "tanh", "sigmoid", "elu", "celu", "selu",
    "softplus", "leaky_relu", "relu6", "hard_sigmoid", "hard_silu",
    "hard_swish", "hard_tanh", "log_sigmoid", "soft_sign", "softmax",
    "log_softmax", "standardize", "normalize", "glu")


def _jax_mlp(name, in_dim=8, mlp_dim=16, out_dim=8):
    import jax
    from multi_modal_transformers_tokenmerge_tpu.modules import (
        attention as jattn)
    jm = jattn.MLPBlock(mlp_dim=mlp_dim, out_dim=out_dim, dropout_rate=0.0,
                        activation=name)
    x = np.random.default_rng(7).normal(size=(2, 5, in_dim)).astype(
        np.float32) * 2.5
    return jm, jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), x


def _mlp_pair(name, in_dim=8, mlp_dim=16, out_dim=8):
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    jm, v, x = _jax_mlp(name, in_dim, mlp_dim, out_dim)
    tm = tattn.MLPBlock(in_dim, mlp_dim, out_dim, activation=name,
                        dropout_rate=0.0, device="cpu")
    p = v["params"]
    with torch.no_grad():
        for layer in ("dense_in", "dense_out"):
            getattr(tm, layer).weight.copy_(torch.tensor(
                np.asarray(p[layer]["kernel"]).T))
            getattr(tm, layer).bias.copy_(torch.tensor(
                np.asarray(p[layer]["bias"])))
    return jm, v, tm, x


@pytest.mark.parametrize("name", ACTIVATION_NAMES)
def test_mlp_activation_matches_flax(name):
    """MLPBlock with each activation on the same input and weights, f32,
    2e-5 (flax gelu is the tanh approximation; glu halves the hidden
    width, so dense_out takes mlp_dim // 2 inputs)."""
    jm, v, tm, x = _mlp_pair(name)
    ref = jm.apply(v, jnp.asarray(x))
    if name == "glu":
        assert tuple(tm.dense_out.weight.shape) == (8, 8)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("name", ["one_hot", "logsumexp", "PReLU",
                                  "no_such_activation"])
def test_activation_jax_cannot_run_raises_at_build(name):
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    with pytest.raises(Exception):       # the JAX block cannot run it
        jm, v, x = _jax_mlp(name)
        jm.apply(v, jnp.asarray(x))
    with pytest.raises(ValueError, match="activation"):
        tattn.MLPBlock(8, 16, 8, activation=name, device="cpu")


@pytest.mark.parametrize("name", ["gelu", "glu", "standardize"])
def test_transformer_stack_activation_matches(name):
    """The whole plain stack with mlp_activation set, weights carried by
    convert.from_flax (glu's narrower dense_out included); f32, 2e-5."""
    base = octo_micro_t5()
    cfg = base.replace(transformer=base.transformer.replace(
        mlp_activation=name))
    jm, v, tm = micro_pair(cfg)
    x = np.random.default_rng(4).normal(size=(2, 16, 32)).astype(np.float32)
    mask = jnp.asarray(tm.layout.attention_mask())
    ref = jm.apply(v, jnp.asarray(x),
                   method=lambda m, y: m.transformer(y, mask=mask,
                                                     deterministic=True))
    with torch.no_grad():
        out = tm.transformer(torch.from_numpy(x), tm.attention_mask)
    assert_close(out, ref, MODULE_TOL)


# -- attention-weight probes --------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attention_probes_match_intermediates(impl):
    """capture_intermediates on the plain stack against the JAX stack's
    apply(..., mutable=['intermediates']): the same flax paths, one entry
    per forward, the blocks stacked on axis 0; f32, 2e-5.  The probe does
    not change the attention path (the port's flash hook, or the plain
    attention) or its output; the JAX side runs its plain attention."""
    from multi_modal_transformers_tokenmerge_torch.models.octo import (
        Octo as TOcto)
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        capture_intermediates)
    from torch_parity import to_torch_config
    base = octo_micro_t5()
    cfg = base.replace(transformer=base.transformer.replace(
        attention=base.transformer.attention.replace(dropout_rate=0.0)))
    jm, v, tm = micro_pair(cfg)
    if impl == "flash":
        tcfg = to_torch_config(cfg)
        port = TOcto(tcfg.replace(transformer=tcfg.transformer.replace(
            attention_impl="flash")), device="cpu", seed=None).eval()
        port.load_state_dict(tm.state_dict())
        assert port.transformer.blocks[0].attention.attention_fn is not None
        tm = port
    x = np.random.default_rng(5).normal(size=(2, 16, 32)).astype(np.float32)
    mask = jnp.asarray(tm.layout.attention_mask())
    _, state = jm.apply(v, jnp.asarray(x), method=lambda m, y: m.transformer(
        y, mask=mask, deterministic=True), mutable=["intermediates"])
    ref = flat_intermediates(state["intermediates"])
    with torch.no_grad():
        plain = tm.transformer(torch.from_numpy(x), tm.attention_mask)
        with capture_intermediates(tm) as probes:
            out = tm.transformer(torch.from_numpy(x), tm.attention_mask)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert sorted(probes) == sorted(ref) == [
        "transformer/blocks/attention/attention_weights"]
    for key, want in ref.items():
        assert len(probes[key]) == len(want) == 1
        assert tuple(probes[key][0].shape) == want[0].shape == (
            2, 2, 2, 16, 16)
        assert probes[key][0].dtype == torch.float32
        assert_close(probes[key][0], want[0], MODULE_TOL)
    assert all(m.probe is None for m in tm.modules() if hasattr(m, "probe"))


def test_probe_masks_with_float32_min():
    """A fully masked query row is uniform in the probe (JAX masks with
    finfo(float32).min), whatever the attention path gives it."""
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        AttentionConfig)
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        MultiHeadAttention, capture_intermediates)
    from multi_modal_transformers_tokenmerge_tpu.core.config import (
        AttentionConfig as JAttentionConfig)
    from multi_modal_transformers_tokenmerge_tpu.modules.attention import (
        MultiHeadAttention as JMHA)
    import jax
    s = 6
    mask = np.tril(np.ones((s, s), bool))
    mask[2] = False
    x = np.random.default_rng(8).normal(size=(2, s, 8)).astype(np.float32)
    jm = JMHA(JAttentionConfig(num_heads=2, qkv_features=8,
                               dropout_rate=0.0))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    _, state = jm.apply(v, jnp.asarray(x), jnp.asarray(mask),
                        mutable=["intermediates"])
    want = state["intermediates"]["attention_weights"][0]
    tm = MultiHeadAttention(AttentionConfig(num_heads=2, qkv_features=8,
                                            dropout_rate=0.0), 8,
                            device="cpu")
    p = v["params"]
    with torch.no_grad():
        for name in ("query", "key", "value"):
            getattr(tm, name).weight.copy_(torch.tensor(
                np.asarray(p[name]["kernel"]).reshape(8, -1).T))
            getattr(tm, name).bias.copy_(torch.tensor(
                np.asarray(p[name]["bias"]).reshape(-1)))
        tm.out.weight.copy_(torch.tensor(
            np.asarray(p["out"]["kernel"]).reshape(-1, 8).T))
        tm.out.bias.copy_(torch.tensor(np.asarray(p["out"]["bias"])))
        with capture_intermediates(tm) as probes:
            tm(torch.from_numpy(x), torch.from_numpy(mask))
    got = probes["attention_weights"][0][0]
    assert_close(got, want, MODULE_TOL)
    torch.testing.assert_close(got[:, :, 2], torch.full((2, 2, s), 1 / s))


def test_probes_refuse_a_graph_capture(monkeypatch):
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    _, _, tm = micro_pair(octo_micro_t5())
    monkeypatch.setattr(tattn, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="eager only"):
        with tattn.capture_intermediates(tm):
            pass


def test_glu_needs_an_even_hidden_width():
    """glu splits the hidden width in two: an odd mlp_dim fails in the JAX
    block and raises when the port's block is built."""
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    with pytest.raises(Exception):
        jm, v, x = _jax_mlp("glu", mlp_dim=15)
        jm.apply(v, jnp.asarray(x))
    with pytest.raises(ValueError, match="odd"):
        tattn.MLPBlock(8, 15, 8, activation="glu", device="cpu")
