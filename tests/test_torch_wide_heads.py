"""The port's flash attention above head dim 256, on the CPU: the plain
versions of the wide kernels (``flash_*_wide_reference``: logits summed
over D in chunks of 64 columns, outputs in slices) at D = 320, 512 and 300
against the JAX package's kernels in interpret mode (forward, LSE and
gradients, under the octo and a causal mask), and the 16-bit order of the
cluster bodies' sums (the 128-column partial logits, and dP, summed in rank
order) at D = 320-768, forward and backward; the mirror of the forwards'
and the backward's launch plans; the chunked, slice-split
plain versions against the unsplit ones, with dropout and the b0 / h0
offsets, and the padding path the card runs for D = 300; the selection of
the flash path at every head dim and every configured tile, and the
configured tiles' plain path bit for bit with the card's tiles; a small
ToMe stack with two heads of 512 against the JAX stack; the ring at D =
512 on two gloo ranks against whole-sequence attention; and octo_deep with
3 heads of 512 converted and held at a small depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import launch, results
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
STACK_TOL = 5 * MODULE_TOL
OCTO = "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"
RATE = 0.1
SEED = torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64)


def _mask(kind):
    if kind == "octo":
        return SequenceLayout.from_strings(OCTO).attention_mask()
    return np.tril(np.ones((96, 96), bool))


def _qkv(s, d, seed, n=4, b=1, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(n)]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_wide_head_dims_compile_to_multiples_of_64():
    """Above 256 a head dim runs at the next multiple of 64, at the wide
    tiles; up to 256 as before; below 1 nothing."""
    want = {257: 320, 300: 320, 320: 320, 384: 384, 512: 512, 576: 576,
            700: 704, 768: 768}
    for d, compiled in want.items():
        assert tfa.compiled_head_dim(d) == compiled
        assert tfa.kernel_tiles(d) == tfa.WIDE_TILES
    assert tfa.compiled_head_dim(256) == 256
    assert tfa.kernel_tiles(256) == tfa.KERNEL_TILES[256]
    assert tfa.kernel_tiles(0) is None
    with pytest.raises(ValueError, match="head dim 0"):
        tfa.compiled_head_dim(0)


@pytest.mark.parametrize("kind", ["octo", "causal"])
@pytest.mark.parametrize("d", [320, 512, 300])
def test_plain_wide_kernels_match_jax_kernels(d, kind):
    """flash_*_wide_reference at the wide tiles against the JAX kernels
    (interpret mode) on the same padded mask and skip tables: out and LSE
    to 2e-5, dq/dk/dv to rtol 2e-4 / atol 2e-5; the wrappers on CPU
    tensors run them and launch nothing."""
    bq, bk = tfa.WIDE_TILES
    mask = _mask(kind)
    q, k, v, do = _qkv(mask.shape[0], d, seed=d)
    padded, k_hi, q_lo = tfa.mask_tables(mask, bq, bk)
    out_j, lse_j = jfa.flash_fwd_lse(q, k, v, padded, k_hi, block_q=bq,
                                     block_k=bk, interpret=True)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tables = (torch.tensor(padded), torch.tensor(k_hi))
    kw = dict(block_q=bq, block_k=bk)
    out_t, lse_t = tfa.flash_fwd_lse_wide_reference(tq, tk, tv, *tables,
                                                    **kw)
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL)
    launches = {n: w.launches for n, w in tfa._WRAPPERS.items()}
    plain = tfa.flash_fwd(tq, tk, tv, *tables, **kw)
    assert torch.equal(plain, tfa.flash_fwd_wide_reference(tq, tk, tv,
                                                           *tables, **kw))
    _close(plain, out_j, FWD_TOL, FWD_TOL)

    lse = torch.tensor(np.asarray(lse_j))
    delta = tfa.attention_delta(tdo, torch.tensor(np.asarray(out_j)),
                                padded.shape[0])
    dq_j, dk_j, dv_j = jfa.flash_bwd(q, k, v, do, lse_j,
                                     jnp.asarray(delta.numpy()), padded,
                                     k_hi, q_lo, block_q=bq, block_k=bk,
                                     interpret=True)
    dq = tfa.flash_dq(tq, tk, tv, tdo, lse, delta, *tables, **kw)
    dk, dv = tfa.flash_dkv(tq, tk, tv, tdo, lse, delta, tables[0],
                           torch.tensor(q_lo), **kw)
    assert torch.equal(dq, tfa.flash_dq_wide_reference(
        tq, tk, tv, tdo, lse, delta, *tables, **kw))
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)
    assert launches == {n: w.launches for n, w in tfa._WRAPPERS.items()}


@pytest.mark.parametrize("d", [320, 512, 576, 768])
def test_cluster_sum_order_matches_jax_kernel(d):
    """The 16-bit wide forwards' order of the logits' sums (the slices'
    partial products over 128 columns, summed in rank order, as the
    cluster body's blocks sum them; odd-slice clusters at 320 and 576, six
    slices at 768), computed in float32, against the JAX forward in
    interpret mode on the octo mask: out and LSE to 2e-5."""
    bq, bk = tfa.WIDE_TILES
    mask = _mask("octo")
    q, k, v = _qkv(mask.shape[0], d, seed=d + 1, n=3)
    padded, k_hi, _ = tfa.mask_tables(mask, bq, bk)
    out_j, lse_j = jfa.flash_fwd_lse(q, k, v, padded, k_hi, block_q=bq,
                                     block_k=bk, interpret=True)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out_t, lse_t = tfa.flash_fwd_lse_reference(
        tq, tk, tv, torch.tensor(padded), torch.tensor(k_hi), block_q=bq,
        block_k=bk, chunk=tfa.WIDE_CHUNKS["fwd"],
        slice_width=tfa.WIDE_SLICES["fwd"])
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL)


# head dim -> (body, blocks of a cluster, columns of the last slice, dynamic
# shared bytes of a block: csrc/flash_attention_wide.cu's ClusterSmem at 3,
# 4, 5, 6 and 8 blocks and FwdSmem)
FWD_PLANS = {300: ("cluster", 3, 64, 112176), 320: ("cluster", 3, 64, 112176),
             512: ("cluster", 4, 128, 103984), 576: ("cluster", 5, 64, 108080),
             768: ("cluster", 6, 128, 112176),
             1024: ("cluster", 8, 128, 120368),
             1152: ("chunked", 1, 128, 81920)}


@pytest.mark.parametrize("d", sorted(FWD_PLANS))
def test_wide_forward_plan(d):
    """The mirror of the forwards' launch plan: up to 8 slices of 128
    columns the slice blocks of a query tile are one cluster, above it the
    chunked body (PR 15's); the 16-bit plain versions cut D as the body
    does, the float32 ones in 64 columns whatever the body."""
    plan = tfa.wide_forward_plan(d)
    assert (plan["body"], plan["cluster"], plan["last_slice"],
            plan["smem"]) == FWD_PLANS[d]
    assert plan["slice"] == 128
    assert plan["chunk"] == (tfa.WIDE_CHUNKS["fwd"] if plan["body"] ==
                             "cluster" else tfa.WIDE_CHUNK)
    x = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16)
    assert tfa._wide_kw("fwd", x) == dict(chunk=plan["chunk"],
                                          slice_width=128)
    assert tfa._wide_kw("fwd", x.float()) == dict(chunk=64, slice_width=64)
    assert tfa._wide_kw("dq", x) == dict(
        chunk=128 if d <= 1024 else 32, slice_width=128)
    with pytest.raises(ValueError, match="narrow"):
        tfa.wide_forward_plan(256)


@pytest.mark.parametrize("d", [320, 512, 576, 768])
def test_cluster_backward_sum_order_matches_jax_kernel(d):
    """The 16-bit wide dq's and dk/dv's order of the sums over D (the
    slices' partial S and dP over 128 columns, summed in rank order, as the
    cluster backward's owners sum them; odd-slice clusters at 320 and 576,
    six slices at 768), computed in float32, against the JAX backward in
    interpret mode on the octo mask: dq, dk and dv to rtol 2e-4 / atol
    2e-5."""
    bq, bk = tfa.WIDE_TILES
    mask = _mask("octo")
    q, k, v, do = _qkv(mask.shape[0], d, seed=d + 2)
    padded, k_hi, q_lo = tfa.mask_tables(mask, bq, bk)
    out_j, lse_j = jfa.flash_fwd_lse(q, k, v, padded, k_hi, block_q=bq,
                                     block_k=bk, interpret=True)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    lse = torch.tensor(np.asarray(lse_j))
    delta = tfa.attention_delta(tdo, torch.tensor(np.asarray(out_j)),
                                padded.shape[0])
    dq_j, dk_j, dv_j = jfa.flash_bwd(q, k, v, do, lse_j,
                                     jnp.asarray(delta.numpy()), padded,
                                     k_hi, q_lo, block_q=bq, block_k=bk,
                                     interpret=True)
    stats = (lse, delta, torch.tensor(padded))
    cut = lambda kind: dict(
        block_q=bq, block_k=bk,
        chunk=tfa.wide_backward_plan(kind, d)["chunk"],
        slice_width=tfa.wide_backward_plan(kind, d)["slice"])
    dq = tfa.flash_dq_reference(tq, tk, tv, tdo, *stats, torch.tensor(k_hi),
                                **cut("dq"))
    dk, dv = tfa.flash_dkv_reference(tq, tk, tv, tdo, *stats,
                                     torch.tensor(q_lo), **cut("dkv"))
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)


# (kind, head dim) -> (body, blocks of a cluster, columns of the last
# slice, dynamic shared bytes of a block, exchange buffers:
# csrc/flash_attention_wide.cu's BwdSmem at 3, 4, 5, 6 and 8 blocks with one
# operand of fragments (dq) and two (dk/dv), two buffers where they fit in
# 227 KB (all but dk/dv at 8 blocks), DqSmem and DkvShape<2>)
BWD_PLANS = {
    **{("dq", d): plan for d, plan in {
        300: ("cluster", 3, 64, 192576, 2), 320: ("cluster", 3, 64, 192576, 2),
        512: ("cluster", 4, 128, 159808, 2),
        576: ("cluster", 5, 64, 176192, 2),
        768: ("cluster", 6, 128, 192576, 2),
        1024: ("cluster", 8, 128, 225344, 2),
        1152: ("chunked", 1, 128, 86016, 1)}.items()},
    **{("dkv", d): plan for d, plan in {
        300: ("cluster", 3, 64, 208960, 2), 320: ("cluster", 3, 64, 208960, 2),
        512: ("cluster", 4, 128, 176192, 2),
        576: ("cluster", 5, 64, 192576, 2),
        768: ("cluster", 6, 128, 208960, 2),
        1024: ("cluster", 8, 128, 159808, 1),
        1152: ("chunked", 1, 128, 173056, 1)}.items()}}


@pytest.mark.parametrize("kind,d", sorted(BWD_PLANS))
def test_wide_backward_plan(kind, d):
    """The mirror of dq's and dk/dv's launch plans: up to 8 slices of 128
    columns the slice blocks of a row tile are one cluster summing the
    partial S and dP of 128 columns (two exchange buffers where they fit a
    block), above it the chunked bodies (chunks of 32 in dq, 64 in dk/dv);
    the 16-bit plain versions cut D as the body does, the float32 ones in
    64 columns whatever the body."""
    plan = tfa.wide_backward_plan(kind, d)
    assert (plan["body"], plan["cluster"], plan["last_slice"], plan["smem"],
            plan["buffers"]) == BWD_PLANS[kind, d]
    assert plan["smem"] <= tfa.WIDE_MAX_SMEM
    assert plan["slice"] == 128
    assert plan["chunk"] == (128 if plan["body"] == "cluster" else
                             tfa.WIDE_CHUNKS[kind])
    x = torch.zeros(1, 1, 1, d, dtype=torch.float16)
    assert tfa._wide_kw(kind, x) == dict(chunk=plan["chunk"],
                                         slice_width=128)
    assert tfa._wide_kw(kind, x.float()) == dict(chunk=64, slice_width=64)
    with pytest.raises(ValueError, match="narrow"):
        tfa.wide_backward_plan(kind, 256)
    with pytest.raises(ValueError, match="kind"):
        tfa.wide_backward_plan("fwd", d)


def _wide_case(d, dtype, b=2, h=3):
    mask = _mask("octo")
    bq, bk = tfa.WIDE_TILES
    q, k, v, do = (torch.tensor(x).to(dtype) for x in
                   _qkv(mask.shape[0], d, seed=7 * d, b=b, h=h))
    tables = tuple(torch.tensor(a) for a in tfa.mask_tables(mask, bq, bk))
    return (q, k, v, do), tables, dict(block_q=bq, block_k=bk)


def _gate(got, want, dtype):
    """chip_smoke.py's gate: 1e-4 (1 + |want|) in float32, two eps (1 +
    |want|) in 16 bits."""
    scale = 1e-4 if dtype == torch.float32 else 2 * torch.finfo(dtype).eps
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= scale * (1 + want.float().abs())).all()), \
        float(diff.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [320, 512])
def test_split_plain_versions_equal_the_unsplit(d, dtype):
    """The plain versions cut as the wide kernels cut D (chunks of 64 for
    the sums over D, slices of the outputs, each recomputing the logits)
    against the same passes unsplit, with dropout, a batch offset and a
    head offset: the masks are the same, the sums differ by float32
    rounding only."""
    dtype = getattr(torch, dtype)
    (q, k, v, do), (padded, k_hi, q_lo), kw = _wide_case(d, dtype)
    kw.update(dropout_rate=RATE, b0=3, h0=2, heads_total=7)
    out, lse = tfa.flash_fwd_lse_wide_reference(q, k, v, padded, k_hi, SEED,
                                                **kw)
    out0, lse0 = tfa.flash_fwd_lse_reference(q, k, v, padded, k_hi, SEED,
                                             **kw)
    _gate(out, out0, dtype)
    _gate(lse, lse0, torch.float32)
    delta = tfa.attention_delta(do, out0, padded.shape[0])
    stats = (lse0, delta, padded)
    dq = tfa.flash_dq_wide_reference(q, k, v, do, *stats, k_hi, SEED, **kw)
    dq0 = tfa.flash_dq_reference(q, k, v, do, *stats, k_hi, SEED, **kw)
    dk, dv = tfa.flash_dkv_wide_reference(q, k, v, do, *stats, q_lo, SEED,
                                          **kw)
    dk0, dv0 = tfa.flash_dkv_reference(q, k, v, do, *stats, q_lo, SEED,
                                       **kw)
    for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
        _gate(got, want, dtype)
    # the offsets reach the wide version's masks
    other, _ = tfa.flash_fwd_lse_wide_reference(
        q, k, v, padded, k_hi, SEED, **{**kw, "b0": 0, "h0": 0,
                                        "heads_total": None})
    assert (other.float() - out.float()).abs().max() > 1e-3


def test_padding_path_at_300_equals_the_unpadded_call():
    """What the card runs at D = 300: operands zero-padded to 320, the true
    1/sqrt(300) as the scale, the outputs cut back, through the wide plain
    versions, against the unpadded unsplit passes, with dropout."""
    (q, k, v, do), (padded, k_hi, q_lo), kw = _wide_case(300, torch.float32)
    kw.update(dropout_rate=RATE)
    out, lse = tfa.at_compiled_dim(tfa.flash_fwd_lse_wide_reference,
                                   (q, k, v), padded, k_hi, SEED, **kw)
    out0, lse0 = tfa.flash_fwd_lse_reference(q, k, v, padded, k_hi, SEED,
                                             **kw)
    assert out.shape == q.shape
    _close(out, out0, FWD_TOL, FWD_TOL)
    _close(lse, lse0, FWD_TOL, FWD_TOL)
    delta = tfa.attention_delta(do, out0, padded.shape[0])
    dq = tfa.at_compiled_dim(tfa.flash_dq_wide_reference, (q, k, v, do),
                             lse0, delta, padded, k_hi, SEED, **kw)
    dk, dv = tfa.at_compiled_dim(tfa.flash_dkv_wide_reference,
                                 (q, k, v, do), lse0, delta, padded, q_lo,
                                 SEED, **kw)
    dq0 = tfa.flash_dq_reference(q, k, v, do, lse0, delta, padded, k_hi,
                                 SEED, **kw)
    dk0, dv0 = tfa.flash_dkv_reference(q, k, v, do, lse0, delta, padded,
                                       q_lo, SEED, **kw)
    for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert got.shape == q.shape
        _close(got, want, GRAD_RTOL, GRAD_ATOL)


def test_wide_wrappers_refuse_what_is_not_a_card_tensor():
    """On a tensor neither on the CPU nor on an sm_90 card the wide
    wrappers raise (padded to 320 first at D = 300), never fall back; the
    kernels' tiles are checked before the device."""
    meta = torch.zeros(1, 74, 2, 300, device="meta")
    padded, k_hi, _ = (torch.tensor(a).to("meta") for a in
                       tfa.mask_tables(_mask("octo"), 64, 64))
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_fwd(meta, meta, meta, padded, k_hi, block_q=64, block_k=64)
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_fwd_lse_wide(meta, meta, meta, padded, k_hi, block_q=64,
                               block_k=64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.flash_fwd(meta, meta, meta, padded, k_hi, block_q=32,
                      block_k=64)


def _attention_cfg(heads, qkv, impl="flash", **transformer):
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        AttentionConfig, TransformerConfig)
    return TransformerConfig(
        attention_impl=impl, **transformer,
        attention=AttentionConfig(num_heads=heads, qkv_features=qkv,
                                  dropout_rate=0.0))


@pytest.mark.parametrize("tiles", [(0, 0), (128, 512), (256, 256)])
@pytest.mark.parametrize("heads,qkv", [(3, 1536), (2, 600), (12, 768)])
def test_select_attention_fn_at_every_head_dim_and_tile(monkeypatch, heads,
                                                        qkv, tiles):
    """On a kernel device (monkeypatched): head dims 512, 300 (padded to
    320) and 64 with the TPU's tiles or none take the flash path under
    'flash', and under 'auto' from flash_min_seq on (the JAX gate) but not
    below it; the hook runs at the card's tiles."""
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    monkeypatch.setattr(tattn, "kernel_device", lambda device: True)
    cfg = _attention_cfg(heads, qkv, flash_block_q=tiles[0],
                         flash_block_k=tiles[1])
    seq = cfg.flash_min_seq
    mask = np.tril(np.ones((seq, seq), bool))
    d = qkv // heads
    for impl in ("flash", "auto"):
        fn = tattn.select_attention_fn(cfg.replace(attention_impl=impl),
                                       mask, seq, "cpu")
        assert fn is not None
        assert fn.tables_for(d, "cpu")[:2] == tfa.kernel_tiles(d)
    auto = cfg.replace(attention_impl="auto")
    assert tattn.select_attention_fn(auto, mask[:74, :74], 74, "cpu") is None


@pytest.mark.parametrize("tiles", [(128, 512), (256, 256)])
@pytest.mark.parametrize("heads,qkv", [(2, 1024), (2, 128)])
def test_configured_tiles_take_the_cards_tiles_bit_for_bit(heads, qkv,
                                                           tiles):
    """A stack's hook built from a config naming the TPU's tiles computes
    bit for bit what the hook at the card's tiles computes, forward and
    gradients, with attention dropout in the kernels' plain versions."""
    from multi_modal_transformers_tokenmerge_torch.modules import (
        attention as tattn)
    mask = _mask("octo")
    s = mask.shape[0]
    d = qkv // heads
    x = [torch.tensor(a) for a in _qkv(s, d, seed=d, n=4, b=2, h=heads)]
    got = []
    for bq, bk in (tiles, (0, 0)):
        cfg = _attention_cfg(heads, qkv, flash_block_q=bq, flash_block_k=bk)
        cfg = cfg.replace(attention=cfg.attention.replace(dropout_rate=RATE))
        fn = tattn.select_attention_fn(cfg, mask, s, "cpu")
        leaves = [t.clone().requires_grad_(True) for t in x[:3]]
        gen = torch.Generator().manual_seed(5)
        out = fn(*leaves, None, dropout_generator=gen)
        out.backward(x[3])
        got.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*got):
        assert torch.equal(a, b)


def _jax_stack(jm, v, x):
    return jm.apply(v, jnp.asarray(x),
                    method=lambda m, t: m.transformer(t, deterministic=True))


def _heads_of_512(**transformer):
    """The micro staged ToMe Octo with two heads of 512 (qkv_features 1024
    over 32 features), attention dropout 0."""
    cfg = octo_micro_tome_staged(**transformer)
    tr = cfg.transformer
    return cfg.replace(transformer=tr.replace(attention=tr.attention.replace(
        num_heads=2, qkv_features=1024, dropout_rate=0.0)))


@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_tome_stack_with_heads_of_512_matches_jax_xla(backward):
    """A small ToMe stack with two heads of 512 and attention_impl='flash'
    (the wide kernels' plain versions on the CPU, either backward) against
    the JAX stack with attention_impl='xla': outputs, and the gradient of
    the sum of squares with respect to the input tokens."""
    jcfg = _heads_of_512()
    jm, v, plain = micro_pair(jcfg)
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(
        attention_impl="flash", flash_backward=backward))
    tm = TOcto(tc, device="cpu", seed=None).eval()
    tm.load_state_dict(plain.state_dict())
    stack = tm.transformer
    assert stack.stage_0[0].attention.head_dim == 512
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
    scale = float(jnp.abs(grad_j).max())
    assert float((xt.grad - torch.tensor(np.asarray(grad_j))).abs().max()) \
        <= 1e-4 * scale


RING_S, RING_D = 128, 512


def test_ring_at_head_dim_512_on_gloo_ranks(tmp_path):
    """Ring attention with impl='flash' at D = 512 on two gloo ranks (the
    wide kernels' plain versions on each 64-token shard, float32 partials
    merged across the steps) against whole-sequence attention: each rank's
    shard of the output and of dq, dk, dv for mean(out^2)."""
    mask = np.tril(np.ones((RING_S, RING_S), bool))
    q, k, v = (torch.tensor(a) for a in _qkv(RING_S, RING_D, seed=11, n=3,
                                             b=1, h=1))
    torch.save({"cases": {"wide": dict(q=q, k=k, v=v, mask=mask,
                                       impl="flash", world=2)}},
               tmp_path / "inputs.pt")
    ranks = launch("ring_checks", 2, tmp_path)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.xla_reference_attention(*leaves, torch.tensor(mask))
    (out.square().sum() / out.numel()).backward()
    s = RING_S // 2
    for rank, res in enumerate(results(ranks, "wide")):
        cols = slice(rank * s, (rank + 1) * s)
        _close(res["out"], out.detach()[:, cols].numpy(), FWD_TOL, FWD_TOL)
        for got, leaf in zip(res["grads"], leaves):
            _close(got, leaf.grad[:, cols].numpy(), GRAD_RTOL, GRAD_ATOL)


def _octo_deep_h512_small():
    """octo_deep with 3 heads of 512 (``num_heads=3``, ``qkv_features=
    1536``, over its 768 features; its sequence and three ToMe stages 224
    -> 160 -> 96) at a small depth: 6 blocks in stages of 2, the text and
    image towers and the heads at micro widths inside (the towers'
    768-wide outputs and the image tower's 100 tokens a frame kept),
    attention dropout 0."""
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
            attention=tr.attention.replace(num_heads=3, qkv_features=1536,
                                           dropout_rate=0.0)),
        heads=h.replace(
            categorical=h.categorical and h.categorical.replace(num_bins=16),
            diffusion=h.diffusion and h.diffusion.replace(
                diffusion_steps=4, time_dim=16, mlp_dim=32)))


def test_octo_deep_h512_converts_and_matches_at_small_depth():
    """octo_deep with 3 heads of 512, as ``load_config("octo_deep",
    ["transformer.attention.num_heads=3",
    "transformer.attention.qkv_features=1536"])`` builds it, cut to 6
    blocks (three stages of 2) and micro towers: ``from_flax`` takes the
    JAX package's parameters (the attention kernels (768, 3, 512)), every
    parameter lands, and the port's compressed stack with
    attention_impl='flash' (the wide plain versions on the CPU) equals the
    JAX stack with attention_impl='xla' on the same tokens."""
    from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import (
        load_config)
    from multi_modal_transformers_tokenmerge_torch.models import presets as tp
    full = load_config("octo_deep", ["transformer.attention.num_heads=3",
                                     "transformer.attention.qkv_features="
                                     "1536"])
    deep = tp.octo_deep()
    assert full == deep.replace(transformer=deep.transformer.replace(
        attention=deep.transformer.attention.replace(num_heads=3,
                                                     qkv_features=1536)))
    assert full.transformer.attention.qkv_features // 3 == 512

    jcfg = _octo_deep_h512_small()
    jm, v, plain = micro_pair(jcfg)
    params = jax.tree.map(np.asarray, v["params"])
    assert sum(p.numel() for p in plain.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    query = [a.shape for path, a in
             jax.tree_util.tree_flatten_with_path(params)[0]
             if "query" in jax.tree_util.keystr(path)]
    assert all(s[-2:] == (3, 512) for s in query)
    assert sum(s[-3:] == (768, 3, 512) for s in query) == 3
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(
        attention_impl="flash", flash_backward="pallas"))
    tm = TOcto(tc, device="cpu", seed=None).eval()
    tm.load_state_dict(convert.from_flax(params, tc))
    stack = tm.transformer
    assert stack.num_stages == 3 and [
        stack.get_buffer(f"mask_{i}").shape[0] for i in range(3)] == [
        224, 160, 96]
    assert stack.stage_0[0].attention.head_dim == 512
    layout = SequenceLayout.from_strings(jcfg.input_sequence,
                                         jcfg.compression_sequence)
    x = np.random.default_rng(6).normal(
        size=(2, layout.total_tokens, 768)).astype(np.float32)
    with torch.no_grad():
        out = stack(torch.tensor(x))
    assert tuple(out.shape) == (2, 96, 768)
    assert_close(out, _jax_stack(jm, v, x), STACK_TOL)
