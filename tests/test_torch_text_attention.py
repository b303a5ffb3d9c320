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
from torch_parity import MODULE_TOL, assert_close, inputs, micro_pair, \
    octo_micro_t5


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
    (6, 0, 0, False),      # head dim 128: no kernel compiled for it
    (12, 32, 32, False),   # head dim 64 with tiles the kernels lack
])
def test_auto_takes_the_kernel_only_where_it_is_compiled(
        monkeypatch, heads, block_q, block_k, compiled):
    """On a kernel device (monkeypatched here) 'auto' at flash_min_seq
    tokens takes the flash path only for a head dim and tiles of
    KERNEL_TILES and the plain path otherwise; 'flash' raises there."""
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        AttentionConfig, TransformerConfig)
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    monkeypatch.setattr(tattn, "kernel_device", lambda device: True)
    cfg = TransformerConfig(
        attention_impl="auto", flash_block_q=block_q, flash_block_k=block_k,
        attention=AttentionConfig(num_heads=heads, qkv_features=768,
                                  dropout_rate=0.0))
    seq = cfg.flash_min_seq
    mask = np.tril(np.ones((seq, seq), bool))
    fn = tattn.select_attention_fn(cfg, mask, seq, "cpu")
    assert (fn is not None) == compiled
    flash = cfg.replace(attention_impl="flash")
    if compiled:
        assert tattn.select_attention_fn(flash, mask, seq, "cpu")
    else:
        with pytest.raises(ValueError, match="compiled"):
            tattn.select_attention_fn(flash, mask, seq, "cpu")
