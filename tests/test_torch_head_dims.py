"""The port's flash attention at every head dim the Pallas kernels take, on
the CPU: the plain versions at D = 32, 128 and 80 against the JAX
package's kernels in interpret mode (forward, LSE and gradients); the
padding path the card runs for a head dim the kernels lack (operands
zero-padded along D to the next compiled dim, the true 1/sqrt(D) as the
scale, outputs cut back) through the plain versions against the unpadded
call, with dropout too; the selection of the flash path by head dim; a
small ToMe stack with two heads of 128 against the JAX stack; and
octo_deep with 6 heads of 128 (``transformer.attention.num_heads=6``)
converted and held at a small depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import MODULE_TOL, assert_close, micro_pair, \
    octo_micro_tome_staged, to_torch_config
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.ops import flash_attention as tfa
from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
    SequenceLayout,
)
from multi_modal_transformers_tokenmerge_tpu.ops import flash_attention as jfa

# tests/test_flash_attention.py:47 (forward) and :123 (gradients)
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
# tests/test_torch_tome_stack.py: a few float32 roundings more than one
# module's 2e-5
STACK_TOL = 5 * MODULE_TOL
OCTO = "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"
RATE = 0.1
SEED = torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64)


def _mask(kind):
    if kind == "octo":
        return SequenceLayout.from_strings(OCTO).attention_mask()
    rng = np.random.default_rng(0)
    s = 40
    mask = rng.random((s, s)) < 0.3
    mask[np.arange(s), np.arange(s)] = True
    if kind == "dead_rows":
        mask[[5, 16, 17, 18, 19, 20, 21, 22, 23]] = False
    return mask


def _qkv(s, d, seed, n=4, b=2, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(n)]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_compiled_head_dims():
    """Every head dim from 1 to 256 runs at a compiled one: itself, or the
    next one up; above 256 at the next multiple of 64, on the wide kernels'
    tiles; below 1 none."""
    want = {1: 32, 20: 32, 32: 32, 33: 64, 64: 64, 72: 128, 80: 128,
            96: 128, 128: 128, 129: 256, 160: 256, 256: 256}
    for d, compiled in want.items():
        assert tfa.compiled_head_dim(d) == compiled
        assert tfa.kernel_tiles(d) == tfa.KERNEL_TILES[compiled]
    assert sorted(tfa.KERNEL_TILES) == [32, 64, 128, 256]
    for d in (257, 264):
        assert tfa.compiled_head_dim(d) == 320
        assert tfa.kernel_tiles(d) == tfa.WIDE_TILES
    assert tfa.kernel_tiles(0) is None
    with pytest.raises(ValueError, match="head dim 0"):
        tfa.compiled_head_dim(0)


@pytest.mark.parametrize("kind", ["blocky", "dead_rows"])
@pytest.mark.parametrize("d", [32, 128, 80])
def test_plain_kernels_match_jax_kernels_at_head_dim(d, kind):
    """flash_*_reference at head dim d against the JAX kernels (interpret
    mode) on the same padded mask and skip tables: out and LSE to 2e-5,
    dq/dk/dv to rtol 2e-4 / atol 2e-5."""
    bq, bk = 16, 8
    mask = _mask(kind)
    q, k, v, do = _qkv(mask.shape[0], d, seed=d)
    padded, k_hi, q_lo = tfa.mask_tables(mask, bq, bk)
    out_j, lse_j = jfa.flash_fwd_lse(q, k, v, padded, k_hi, block_q=bq,
                                     block_k=bk, interpret=True)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tables = (torch.tensor(padded), torch.tensor(k_hi))
    out_t, lse_t = tfa.flash_fwd_lse_reference(tq, tk, tv, *tables,
                                               block_q=bq, block_k=bk)
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL)
    plain = tfa.flash_fwd_reference(tq, tk, tv, *tables, block_q=bq,
                                    block_k=bk)
    _close(plain, out_j, FWD_TOL, FWD_TOL)

    lse = torch.tensor(np.asarray(lse_j))
    delta = tfa.attention_delta(tdo, torch.tensor(np.asarray(out_j)),
                                padded.shape[0])
    dq_j, dk_j, dv_j = jfa.flash_bwd(q, k, v, do, lse_j,
                                     jnp.asarray(delta.numpy()), padded,
                                     k_hi, q_lo, block_q=bq, block_k=bk,
                                     interpret=True)
    dq = tfa.flash_dq_reference(tq, tk, tv, tdo, lse, delta, *tables,
                                block_q=bq, block_k=bk)
    dk, dv = tfa.flash_dkv_reference(tq, tk, tv, tdo, lse, delta,
                                     tables[0], torch.tensor(q_lo),
                                     block_q=bq, block_k=bk)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("d", [32, 128, 80])
def test_autograd_matches_jax_at_head_dim(d):
    """flash_attention (forward and the dq/dk-dv backward) at head dim d
    against jax.vjp of the JAX flash_attention with backward='pallas' in
    interpret mode, at the kernels' default tiles of both packages."""
    mask = _mask("octo")
    q, k, v, g = _qkv(mask.shape[0], d, seed=d + 1)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, mask, interpret=True,
                                            backward="pallas"), q, k, v)
    grads_j = vjp(g)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, mask)
    out_t.backward(torch.tensor(g))
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    for t, want in zip((tq, tk, tv), grads_j):
        _close(t.grad, want, GRAD_RTOL, GRAD_ATOL)


def _padded_case(d, rate):
    mask = _mask("octo")
    bq, bk = tfa.kernel_tiles(d)
    q, k, v, do = (torch.tensor(x) for x in
                   _qkv(mask.shape[0], d, seed=3 * d))
    padded, k_hi, q_lo = (torch.tensor(a) for a in
                          tfa.mask_tables(mask, bq, bk))
    seed = SEED if rate else None
    kw = dict(block_q=bq, block_k=bk, dropout_rate=rate)
    return (q, k, v, do), (padded, k_hi, q_lo), seed, kw


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("d", [20, 72, 80, 160])
def test_padding_path_equals_the_unpadded_call(d, rate):
    """What the card runs for a head dim the kernels lack, through the
    plain versions: every pass with its operands zero-padded along D to
    compiled_head_dim(d) and the true 1/sqrt(d) as its scale, the outputs
    cut back to d, against the same pass unpadded at d (forward, LSE, dq,
    dk, dv; with dropout the same keep masks, the counter not involving
    D).  The padded outputs' extra columns are exactly zero."""
    (q, k, v, do), (padded, k_hi, q_lo), seed, kw = _padded_case(d, rate)
    dp = tfa.compiled_head_dim(d)
    assert dp > d
    out, lse = tfa.at_compiled_dim(tfa.flash_fwd_lse_reference, (q, k, v),
                                   padded, k_hi, seed, **kw)
    out0, lse0 = tfa.flash_fwd_lse_reference(q, k, v, padded, k_hi, seed,
                                             **kw)
    assert out.shape == q.shape and out.is_contiguous()
    _close(out, out0, FWD_TOL, FWD_TOL)
    _close(lse, lse0, FWD_TOL, FWD_TOL)
    if not rate:
        fwd = tfa.at_compiled_dim(tfa.flash_fwd_reference, (q, k, v),
                                  padded, k_hi, block_q=kw["block_q"],
                                  block_k=kw["block_k"])
        _close(fwd, out0, FWD_TOL, FWD_TOL)
    delta = tfa.attention_delta(do, out0, padded.shape[0])
    stats = (lse0, delta, padded)
    dq = tfa.at_compiled_dim(tfa.flash_dq_reference, (q, k, v, do), *stats,
                             k_hi, seed, **kw)
    dk, dv = tfa.at_compiled_dim(tfa.flash_dkv_reference, (q, k, v, do),
                                 *stats, q_lo, seed, **kw)
    dq0 = tfa.flash_dq_reference(q, k, v, do, *stats, k_hi, seed, **kw)
    dk0, dv0 = tfa.flash_dkv_reference(q, k, v, do, *stats, q_lo, seed,
                                       **kw)
    for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert got.shape == q.shape
        _close(got, want, GRAD_RTOL, GRAD_ATOL)
    # the padded pass itself: its extra columns are zeros
    wide = [torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v, do)]
    scale = 1.0 / np.sqrt(d)
    out_w, _ = tfa.flash_fwd_lse_reference(*wide[:3], padded, k_hi, seed,
                                           scale=scale, **kw)
    dk_w, dv_w = tfa.flash_dkv_reference(*wide, *stats, q_lo, seed,
                                         scale=scale, **kw)
    dq_w = tfa.flash_dq_reference(*wide, *stats, k_hi, seed, scale=scale,
                                  **kw)
    for t in (out_w, dq_w, dk_w, dv_w):
        assert not t[..., d:].any()


@pytest.mark.parametrize("d", [80, 160])
def test_padding_path_with_the_offsets(d):
    """The padded passes with a batch offset b0 and a head offset h0 of
    heads_total draw the unpadded call's masks."""
    (q, k, v, do), (padded, k_hi, q_lo), seed, kw = _padded_case(d, RATE)
    kw.update(b0=3, h0=2, heads_total=5)
    out, lse = tfa.at_compiled_dim(tfa.flash_fwd_lse_reference, (q, k, v),
                                   padded, k_hi, seed, **kw)
    out0, lse0 = tfa.flash_fwd_lse_reference(q, k, v, padded, k_hi, seed,
                                             **kw)
    _close(out, out0, FWD_TOL, FWD_TOL)
    delta = tfa.attention_delta(do, out0, padded.shape[0])
    dk, dv = tfa.at_compiled_dim(tfa.flash_dkv_reference, (q, k, v, do),
                                 lse0, delta, padded, q_lo, seed, **kw)
    dk0, dv0 = tfa.flash_dkv_reference(q, k, v, do, lse0, delta, padded,
                                       q_lo, seed, **kw)
    _close(dk, dk0, GRAD_RTOL, GRAD_ATOL)
    _close(dv, dv0, GRAD_RTOL, GRAD_ATOL)
    # the offsets change the masks: the call without them differs
    other, _ = tfa.flash_fwd_lse_reference(q, k, v, padded, k_hi, seed,
                                           **{**kw, "b0": 0, "h0": 0,
                                              "heads_total": None})
    assert (other - out0).abs().max() > 1e-3


def _attention_cfg(heads, qkv, impl="flash", **transformer):
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        AttentionConfig, TransformerConfig)
    return TransformerConfig(
        attention_impl=impl, **transformer,
        attention=AttentionConfig(num_heads=heads, qkv_features=qkv,
                                  dropout_rate=0.0))


def test_select_attention_fn_by_head_dim(monkeypatch):
    """On a kernel device (monkeypatched): head dim 128 takes the flash
    path under 'flash' and under 'auto' from flash_min_seq on (the JAX
    gate, not below it), at the tiles the card runs 128 at; a padded head
    dim (96) too; head dim 264 takes it under 'flash' and 'auto' alike (the
    wide kernels, padded to 320)."""
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    monkeypatch.setattr(tattn, "kernel_device", lambda device: True)
    for heads, qkv in ((6, 768), (8, 768)):
        cfg = _attention_cfg(heads, qkv)
        seq = cfg.flash_min_seq
        mask = np.tril(np.ones((seq, seq), bool))
        fn = tattn.select_attention_fn(cfg, mask, seq, "cpu")
        d = qkv // heads
        assert fn.tables_for(d, "cpu")[:2] == tfa.KERNEL_TILES[128]
        auto = cfg.replace(attention_impl="auto")
        assert tattn.select_attention_fn(auto, mask, seq, "cpu")
        assert tattn.select_attention_fn(auto, mask[:74, :74], 74,
                                         "cpu") is None
    wide = _attention_cfg(2, 528)
    mask = np.tril(np.ones((1024, 1024), bool))
    fn = tattn.select_attention_fn(wide, mask, 1024, "cpu")
    assert fn.tables_for(264, "cpu")[:2] == tfa.WIDE_TILES
    assert tattn.select_attention_fn(wide.replace(attention_impl="auto"),
                                     mask, 1024, "cpu")
    # on the CPU 'flash' takes every head dim: the plain versions
    monkeypatch.setattr(tattn, "kernel_device", lambda device: False)
    assert tattn.select_attention_fn(wide, mask, 1024, "cpu")


def _jax_stack(jm, v, x):
    return jm.apply(v, jnp.asarray(x),
                    method=lambda m, t: m.transformer(t, deterministic=True))


def _heads_of_128(**transformer):
    """The micro staged ToMe Octo with two heads of 128 (qkv_features 256
    over 32 features), attention dropout 0."""
    cfg = octo_micro_tome_staged(**transformer)
    tr = cfg.transformer
    return cfg.replace(transformer=tr.replace(attention=tr.attention.replace(
        num_heads=2, qkv_features=256, dropout_rate=0.0)))


TOME_128 = {"staged_merge": lambda: _heads_of_128(),
            "two_blocks_prestack": lambda: _heads_of_128(
                num_blocks=2, tome_merge_every=2, prestack_merge=True)}


@pytest.mark.parametrize("backward", ["pallas", "xla"])
@pytest.mark.parametrize("case", sorted(TOME_128))
def test_tome_stack_with_heads_of_128_matches_jax_xla(case, backward):
    """A small ToMe stack with two heads of 128 and attention_impl='flash'
    (the kernels' plain versions on the CPU, either backward) against the
    JAX stack with attention_impl='xla': outputs, and the gradient of the
    sum of squares with respect to the input tokens."""
    jcfg = TOME_128[case]()
    jm, v, plain = micro_pair(jcfg)
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(
        attention_impl="flash", flash_backward=backward))
    tm = TOcto(tc, device="cpu", seed=None).eval()
    tm.load_state_dict(plain.state_dict())
    stack = tm.transformer
    hook = stack.stage_0[0].attention.attention_fn
    assert hook is not None and stack.stage_0[0].attention.head_dim == 128
    layout = SequenceLayout.from_strings(jcfg.input_sequence,
                                         jcfg.compression_sequence)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, layout.total_tokens,
                         jcfg.token_embedding_dim)).astype(np.float32)
    ref = _jax_stack(jm, v, x)
    grad_j = jax.grad(lambda t: jnp.sum(_jax_stack(jm, v, t) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = stack(xt)
    out.square().sum().backward()
    assert_close(out, ref, STACK_TOL)
    # within 1e-4 of the largest gradient, as tests/test_torch_train.py
    scale = float(jnp.abs(grad_j).max())
    assert float((xt.grad - torch.tensor(np.asarray(grad_j))).abs().max()) \
        <= 1e-4 * scale


def _octo_deep_h128_small():
    """octo_deep with ``transformer.attention.num_heads=6`` (6 heads of 128
    over its 768 features, its sequence and three ToMe stages 224 -> 160 ->
    96) at a small depth: 6 blocks in stages of 2, the text and image
    towers and the heads at micro widths inside (the towers' 768-wide
    outputs and the image tower's 100 tokens a frame kept), attention
    dropout 0."""
    from multi_modal_transformers_tokenmerge_tpu.core.config import (
        ResNetEmbedderConfig)
    from multi_modal_transformers_tokenmerge_tpu.models import presets as jp
    cfg = jp.octo_deep()
    tr = cfg.transformer
    side = cfg.images.patches_per_dim
    h = cfg.heads
    return cfg.replace(
        text=cfg.text.replace(vocab_size=64, t5_num_layers=2,
                              t5_num_heads=2, t5_d_ff=48, t5_d_kv=8),
        images=cfg.images.replace(
            image_size=(side * 16, side * 16, 3), patch_size=16,
            position_interval=16,
            resnet=ResNetEmbedderConfig(
                num_blocks=1, features=8, input_kernel=(4, 4),
                input_stride=(2, 2), group_norm_groups=4,
                output_features=768)),
        transformer=tr.replace(
            num_blocks=6, tome_merge_every=2,
            attention=tr.attention.replace(num_heads=6, dropout_rate=0.0)),
        heads=h.replace(
            categorical=h.categorical and h.categorical.replace(num_bins=16),
            diffusion=h.diffusion and h.diffusion.replace(
                diffusion_steps=4, time_dim=16, mlp_dim=32)))


def test_octo_deep_h128_converts_and_matches_at_small_depth():
    """octo_deep with 6 heads of 128, as ``load_config("octo_deep",
    ["transformer.attention.num_heads=6"])`` builds it, cut to 6 blocks
    (three stages of 2) and micro towers: ``from_flax`` takes the JAX
    package's parameters (the attention kernels (768, 6, 128)), every
    parameter lands, and the port's compressed stack with
    attention_impl='flash' (the plain versions on the CPU) equals the JAX
    stack with attention_impl='xla' on the same tokens."""
    from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import (
        load_config)
    from multi_modal_transformers_tokenmerge_torch.models import presets as tp
    full = load_config("octo_deep", ["transformer.attention.num_heads=6"])
    deep = tp.octo_deep()
    assert full == deep.replace(transformer=deep.transformer.replace(
        attention=deep.transformer.attention.replace(num_heads=6)))
    assert full.transformer.attention.qkv_features // 6 == 128

    jcfg = _octo_deep_h128_small()
    jm, v, plain = micro_pair(jcfg)
    params = jax.tree.map(np.asarray, v["params"])
    assert sum(p.numel() for p in plain.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    # every stage's query kernels and biases (stacked over its blocks)
    query = [a.shape for path, a in
             jax.tree_util.tree_flatten_with_path(params)[0]
             if "query" in jax.tree_util.keystr(path)]
    assert all(s[-2:] == (6, 128) for s in query)
    assert sum(s[-3:] == (768, 6, 128) for s in query) == 3
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(
        attention_impl="flash", flash_backward="pallas"))
    tm = TOcto(tc, device="cpu", seed=None).eval()
    tm.load_state_dict(convert.from_flax(params, tc))
    stack = tm.transformer
    assert stack.num_stages == 3 and [
        stack.get_buffer(f"mask_{i}").shape[0] for i in range(3)] == [
        224, 160, 96]
    layout = SequenceLayout.from_strings(jcfg.input_sequence,
                                         jcfg.compression_sequence)
    x = np.random.default_rng(6).normal(
        size=(2, layout.total_tokens, 768)).astype(np.float32)
    with torch.no_grad():
        out = stack(torch.tensor(x))
    assert tuple(out.shape) == (2, 96, 768)
    assert_close(out, _jax_stack(jm, v, x), STACK_TOL)
