"""The port's flash attention on the CPU: the plain versions of the
forward, forward/LSE, dq and dk/dv kernels and both autograd paths against
the JAX package's Pallas kernels in interpret mode, the skip tables, the
Philox dropout masks, and the attention-core selection of
``modules.attention``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_configs import octo_micro
from torch_parity import to_torch_config
from multi_modal_transformers_tokenmerge_torch.modules.attention import (
    select_attention_fn,
)
from multi_modal_transformers_tokenmerge_torch.ops import flash_attention as tfa
from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
    SequenceLayout,
)
from multi_modal_transformers_tokenmerge_tpu.ops import flash_attention as jfa

# tests/test_flash_attention.py:47 (forward) and :123 (gradients)
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
OCTO = "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"


def _mask(kind):
    if kind == "octo":
        return SequenceLayout.from_strings(OCTO).attention_mask()
    rng = np.random.default_rng(0)
    s = 40
    mask = rng.random((s, s)) < 0.3
    mask[np.arange(s), np.arange(s)] = True
    if kind == "dead_rows":
        # rows with no allowed key, one of them filling a whole q tile
        mask[[5, 16, 17, 18, 19, 20, 21, 22, 23]] = False
    return mask


CASES = [("octo", 16, 16), ("octo", 32, 16), ("blocky", 8, 8),
         ("blocky", 16, 8), ("dead_rows", 8, 8), ("dead_rows", 8, 16)]


def _qkv(s, seed, n=4, b=2, h=3, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(n)]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind,bq,bk", CASES)
def test_plain_kernels_match_jax_kernels(kind, bq, bk):
    """flash_*_reference against the JAX kernels (interpret mode) on the
    same padded mask and skip tables: out and LSE to 2e-5, dq/dk/dv to
    rtol 2e-4 / atol 2e-5, dead rows included."""
    mask = _mask(kind)
    q, k, v, do = _qkv(mask.shape[0], seed=1)
    padded, k_hi, q_lo = tfa.mask_tables(mask, bq, bk)
    out_j, lse_j = jfa.flash_fwd_lse(q, k, v, padded, k_hi, block_q=bq,
                                     block_k=bk, interpret=True)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tables = (torch.tensor(padded), torch.tensor(k_hi))
    out_t, lse_t = tfa.flash_fwd_lse_reference(tq, tk, tv, *tables,
                                               block_q=bq, block_k=bk)
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    _close(lse_t, lse_j, FWD_TOL, FWD_TOL)

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
    if kind == "dead_rows":
        assert not out_t[:, 5].any() and not dq[:, 5].any()


@pytest.mark.parametrize("kind,bq,bk", CASES)
def test_autograd_matches_jax(kind, bq, bk):
    """flash_attention (forward + dq/dk-dv backward through
    autograd.Function) against jax.vjp of the JAX flash_attention with
    backward='pallas' in interpret mode."""
    import jax
    mask = _mask(kind)
    q, k, v, g = _qkv(mask.shape[0], seed=2)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, mask, block_q=bq,
                                            block_k=bk, interpret=True,
                                            backward="pallas"), q, k, v)
    grads_j = vjp(g)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, mask, block_q=bq, block_k=bk)
    out_t.backward(torch.tensor(g))
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    for t, want in zip((tq, tk, tv), grads_j):
        _close(t.grad, want, GRAD_RTOL, GRAD_ATOL)


OCTO_DEEP = ("[TaskDescriptionPrefix{16}] [Image{100};Readout{4}]*2",
             "[TaskDescriptionPrefix{0}] [Image{32};Readout{0}]*2")
OCTO_SMALL = (OCTO, "[TaskDescriptionPrefix{0}] [Image{4};Readout{0}]*2")


def _stage_mask(strings, stage):
    return SequenceLayout.from_strings(*strings).attention_mask(stage)


# the ToMe stage masks the staged stack hands the kernel, blocky masks and
# dead rows: (mask, block_q, block_k)
FWD_CASES = {
    "octo_deep_stage1_160": lambda: (_stage_mask(OCTO_DEEP, 1), 64, 64),
    "octo_deep_stage2_96": lambda: (_stage_mask(OCTO_DEEP, 2), 64, 64),
    "octo_deep_stage2_96_tiles32": lambda: (_stage_mask(OCTO_DEEP, 2), 32,
                                            32),
    "octo_small_stage0_74": lambda: (_stage_mask(OCTO_SMALL, 0), 32, 32),
    "octo_small_stage1_66": lambda: (_stage_mask(OCTO_SMALL, 1), 32, 32),
    "octo_small_stage2_58": lambda: (_stage_mask(OCTO_SMALL, 2), 16, 32),
    "blocky": lambda: (_mask("blocky"), 8, 8),
    "blocky_16_8": lambda: (_mask("blocky"), 16, 8),
    "dead_rows": lambda: (_mask("dead_rows"), 8, 8),
    "dead_rows_8_16": lambda: (_mask("dead_rows"), 8, 16),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_plain_forward_matches_jax_flash_kernel(case):
    """flash_fwd_reference against the JAX ``_flash_kernel`` in interpret
    mode (``flash_attention(interpret=True, backward='xla')``) on the same
    tiles: rtol 2e-4 / atol 2e-5, zeros on dead rows; ``flash_fwd`` takes
    the plain version for CPU tensors and launches nothing."""
    mask, bq, bk = FWD_CASES[case]()
    s = mask.shape[0]
    q, k, v = _qkv(s, seed=5, n=3, b=2, h=2)
    out_j = jfa.flash_attention(q, k, v, mask, block_q=bq, block_k=bk,
                                interpret=True, backward="xla")
    padded, k_hi, _ = (torch.tensor(a) for a in tfa.mask_tables(mask, bq, bk))
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out_t = tfa.flash_fwd_reference(tq, tk, tv, padded, k_hi, block_q=bq,
                                    block_k=bk)
    _close(out_t, out_j, GRAD_RTOL, GRAD_ATOL)
    before = tfa.flash_fwd.launches
    again = tfa.flash_fwd(tq, tk, tv, padded, k_hi, block_q=bq, block_k=bk)
    assert torch.equal(again, out_t) and tfa.flash_fwd.launches == before
    # the LSE-saving forward computes the same output
    with_lse, _ = tfa.flash_fwd_lse_reference(tq, tk, tv, padded, k_hi,
                                              block_q=bq, block_k=bk)
    assert torch.equal(with_lse, out_t)
    dead = ~mask.any(axis=1)
    if case.startswith("dead_rows"):
        assert dead.sum() == 9
    assert not out_t[:, torch.tensor(dead)].any()


@pytest.mark.parametrize("kind,bq,bk", CASES)
def test_xla_backward_matches_jax_grad(kind, bq, bk):
    """flash_attention(backward='xla') (the forward kernel's plain version,
    gradients recomputed through xla_reference_attention) against jax.grad
    through the JAX ``_xla_reference_attention``, which is what the JAX
    ``_flash_vjp_bwd`` differentiates: rtol 1e-4 / atol 1e-5 as
    tests/test_flash_attention.py:101-106, zero gradient on dead rows."""
    import jax
    mask = _mask(kind)
    q, k, v, g = _qkv(mask.shape[0], seed=6)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jfa._xla_reference_attention(a, b, c,
                                                     jnp.asarray(mask)),
        q, k, v)
    grads_j = vjp(g)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, mask, block_q=bq, block_k=bk,
                                backward="xla")
    out_t.backward(torch.tensor(g))
    _close(out_t, out_j, FWD_TOL, FWD_TOL)
    for t, want in zip((tq, tk, tv), grads_j):
        _close(t.grad, want, 1e-4, 1e-5)
    if kind == "dead_rows":
        assert not out_t[:, 5].any() and not tq.grad[:, 5].any()
    # and both backward routes of the port differentiate the same function
    pq, pk, pv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tfa.flash_attention(pq, pk, pv, mask, block_q=bq, block_k=bk,
                        backward="pallas").backward(torch.tensor(g))
    for a, b in zip((tq, tk, tv), (pq, pk, pv)):
        _close(a.grad, b.grad.numpy(), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("kind,bq,bk", CASES)
def test_skip_tables_match_jax(kind, bq, bk):
    mask = _mask(kind)
    padded, k_hi, q_lo = tfa.mask_tables(mask, bq, bk)
    s = mask.shape[0]
    assert padded.shape[0] % bq == 0 and padded.shape[0] % bk == 0
    assert (padded[:s, :s] == mask).all() and not padded[s:].any()
    j_hi, j_lo = jfa.tile_skip_tables(padded, bq, bk)
    np.testing.assert_array_equal(k_hi, j_hi)
    np.testing.assert_array_equal(q_lo, j_lo)
    # cached per (mask digest, tiles, device)
    first = tfa.device_tables(mask, bq, bk, "cpu")
    assert tfa.device_tables(mask.copy(), bq, bk, "cpu") is first
    for got, want in zip(first, (padded, k_hi, q_lo)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate", [0.1, 0.25])
@pytest.mark.parametrize("kind", ["octo", "dead_rows"])
def test_dropout_matches_autograd_through_plain_attention(kind, rate):
    """With dropout the kernels' backward equals torch autograd through
    the plain attention under the same regenerated Philox mask, whatever
    the tiles."""
    mask = _mask(kind)
    q, k, v, g = _qkv(mask.shape[0], seed=3)
    seed = torch.tensor([12345, 987654321], dtype=torch.int64)

    def run(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = fn(*ts)
        out.backward(torch.tensor(g))
        return out.detach(), [t.grad for t in ts]

    ref_out, ref_grads = run(lambda a, b, c: tfa.xla_reference_attention(
        a, b, c, torch.tensor(mask), dropout_rate=rate, dropout_seed=seed))
    for bq, bk in ((8, 16), (16, 8)):
        out, grads = run(lambda a, b, c: tfa.flash_attention(
            a, b, c, mask, block_q=bq, block_k=bk, dropout_rate=rate,
            dropout_seed=seed))
        _close(out, ref_out.numpy(), FWD_TOL, FWD_TOL)
        for got, want in zip(grads, ref_grads):
            _close(got, want.numpy(), GRAD_RTOL, GRAD_ATOL)
    # dropout changes the function
    plain = tfa.xla_reference_attention(*(torch.tensor(x) for x in (q, k, v)),
                                        torch.tensor(mask))
    assert (plain - ref_out).abs().max() > 1e-3


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate(rate):
    """The share of kept elements is within 4 sigma of 1 - r."""
    seed = torch.tensor([7, 2 ** 32 - 3], dtype=torch.int64)
    idx = torch.arange(256)
    keep = tfa.dropout_keep_mask(seed, 4, 4, idx, idx, rate)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 4 * sigma
    # element masks depend on (b, h, row, col) only, not on the slice asked
    sub = tfa.dropout_keep_mask(seed, 4, 4, idx[40:72], idx[8:24], rate)
    assert torch.equal(sub, keep[:, :, 40:72, 8:24])


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_batch_offset_draws_the_global_rows(rate):
    """``b0``: the plain forward, dq and dk/dv of rows b0.. of a batch, with
    b0 passed, equal those rows of the whole batch's call (the Philox
    counters count global rows), for every batch offset; b0=0 is the call
    without it, bit for bit; under ``data_parallel`` of ranks holding two
    rows each, ``flash_attention`` offsets rank r by 2r."""
    mask = _mask("octo")
    q, k, v, do = (torch.tensor(x) for x in _qkv(mask.shape[0], seed=4,
                                                b=4))
    seed = torch.tensor([99, 2 ** 31 + 5], dtype=torch.int64)
    padded, k_hi, q_lo = (torch.tensor(a)
                          for a in tfa.mask_tables(mask, 16, 16))
    kw = dict(block_q=16, block_k=16, dropout_rate=rate)
    out, lse = tfa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
    delta = tfa.attention_delta(do, out, padded.shape[0])
    dq = tfa.flash_dq(q, k, v, do, lse, delta, padded, k_hi, seed, **kw)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, padded, q_lo, seed, **kw)
    for b0 in (0, 1, 2):
        rows = slice(b0, b0 + 2)
        part = lambda t: t[rows].contiguous()
        o2, l2 = tfa.flash_fwd_lse(part(q), part(k), part(v), padded, k_hi,
                                   seed, b0=b0, **kw)
        assert torch.equal(o2, out[rows]) and torch.equal(l2, lse[rows])
        args = (part(q), part(k), part(v), part(do), part(lse), part(delta),
                padded)
        assert torch.equal(tfa.flash_dq(*args, k_hi, seed, b0=b0, **kw),
                           dq[rows])
        dk2, dv2 = tfa.flash_dkv(*args, q_lo, seed, b0=b0, **kw)
        assert torch.equal(dk2, dk[rows]) and torch.equal(dv2, dv[rows])
        if rate and b0:
            # without the offset the rows draw other masks
            other = tfa.flash_fwd_lse(part(q), part(k), part(v), padded,
                                      k_hi, seed, **kw)[0]
            assert not torch.equal(other, out[rows])
    idx = torch.arange(8)
    assert torch.equal(
        tfa.dropout_keep_mask(seed, 2, 3, idx, idx, 0.1, b0=2),
        tfa.dropout_keep_mask(seed, 4, 3, idx, idx, 0.1)[2:])


class _TwoRanks:
    """A stand-in for a two-rank process group (rank 1)."""


def test_flash_attention_takes_the_rank_offset(monkeypatch):
    from multi_modal_transformers_tokenmerge_torch.core import global_batch
    mask = _mask("octo")
    q, k, v = (torch.tensor(x) for x in _qkv(mask.shape[0], seed=5, n=3,
                                            b=4))
    seed = torch.tensor([3, 4], dtype=torch.int64)
    kw = dict(block_q=16, block_k=16, dropout_rate=0.1, dropout_seed=seed)
    whole = tfa.flash_attention(q, k, v, mask, **kw)
    group = _TwoRanks()
    monkeypatch.setattr(global_batch.dist, "get_world_size",
                        lambda g=None: 2)
    monkeypatch.setattr(global_batch.dist, "get_rank", lambda g=None: 1)
    assert global_batch.row_offset(2) == 0
    with global_batch.data_parallel(group):
        assert global_batch.row_offset(2) == 2
        mine = tfa.flash_attention(q[2:], k[2:], v[2:], mask, **kw)
    assert torch.equal(mine, whole[2:])


def test_philox_known_answers():
    """The Philox4x32-10 of the kernels against Random123's known-answer
    vectors."""
    t = lambda x: torch.tensor(x, dtype=torch.int64)
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        got = tfa._philox4x32(*map(t, ctr), *map(t, key))
        assert tuple(int(w) for w in got) == want


def test_entry_checks():
    mask = _mask("octo")
    q = torch.zeros(1, 74, 2, 64)
    # backward='xla' computes (zeros in, zeros out) and takes no dropout
    assert not tfa.flash_attention(q, q, q, mask, backward="xla").any()
    with pytest.raises(ValueError, match="backward='pallas'"):
        tfa.flash_attention(q, q, q, mask, backward="xla", dropout_rate=0.1,
                            dropout_seed=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="unknown backward"):
        tfa.flash_attention(q, q, q, mask, backward="cudnn")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, mask, dropout_rate=0.1)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q, torch.tensor(mask))
    # a tensor neither on the CPU nor on an sm_90 card: raise, never fall
    # back to the plain version
    meta = torch.zeros(1, 74, 2, 64, device="meta")
    padded, k_hi, _ = (torch.tensor(a) for a in tfa.mask_tables(mask, 64,
                                                                 64))
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_fwd_lse(meta, meta, meta, padded.to("meta"),
                          k_hi.to("meta"), block_q=64, block_k=64)
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_fwd(meta, meta, meta, padded.to("meta"), k_hi.to("meta"),
                      block_q=64, block_k=64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.flash_fwd(meta, meta, meta, padded.to("meta"), k_hi.to("meta"),
                      block_q=32, block_k=64)
    # a head dim the kernels lack runs padded to the next compiled one (16
    # to 32, whose tiles are 64 x 64), so on the meta device it reaches the
    # device check; so does one above 256, on the wide kernels (264 padded
    # to 320, whose tiles are 64 x 64 too)
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_fwd_lse(meta[..., :16], meta[..., :16], meta[..., :16],
                          padded.to("meta"), k_hi.to("meta"), block_q=64,
                          block_k=64)
    wide = torch.zeros(1, 74, 2, 264, device="meta")
    with pytest.raises(RuntimeError, match="sm_90"):
        tfa.flash_fwd_lse(wide, wide, wide, padded.to("meta"),
                          k_hi.to("meta"), block_q=64, block_k=64)


def test_tables_first_built_while_serving_can_train():
    """A mask's device tables are cached; built for the first time under
    inference mode (a served request), they must still be savable for a
    later backward pass."""
    rng = np.random.default_rng(7)
    mask = rng.random((24, 24)) < 0.5
    mask[np.arange(24), np.arange(24)] = True
    q, k, v = (torch.tensor(x) for x in _qkv(24, seed=9, n=3))
    for backward in ("xla", "pallas"):
        fn = tfa.make_attention_fn(mask ^ (backward == "xla"), block_q=8,
                                   block_k=8, backward=backward)
        with torch.inference_mode():
            served = fn(q, k, v)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.sum().backward()
        assert torch.equal(out.detach(), served)
        assert all(torch.isfinite(x.grad).all() for x in leaves)


def _tcfg(**transformer):
    cfg = to_torch_config(octo_micro())
    return cfg.transformer.replace(**transformer)


def test_select_attention_fn():
    """The JAX package's selection rules (modules/attention.py:39-69)."""
    mask = _mask("octo")
    assert select_attention_fn(_tcfg(attention_impl="xla"), mask, 74) is None
    assert select_attention_fn(_tcfg(attention_impl="flash"), mask, 74)
    # 'auto' takes the kernel only on an sm_90 card from flash_min_seq on
    for seq in (74, 4096):
        assert select_attention_fn(_tcfg(attention_impl="auto"), mask, seq,
                                   "cpu") is None
    with pytest.raises(ValueError):
        select_attention_fn(_tcfg(attention_impl="tpu"), mask, 74)
    drop = _tcfg(attention_impl="flash", flash_backward="xla")
    assert drop.attention.dropout_rate > 0
    with pytest.raises(ValueError, match="flash_backward='pallas'"):
        select_attention_fn(drop, mask, 74)
    assert select_attention_fn(drop.replace(attention_impl="auto"), mask,
                               4096, "cpu") is None
    no_drop = drop.replace(attention=drop.attention.replace(dropout_rate=0.0))
    # flash_backward='xla' without weight dropout: the hook of the forward
    # kernel without LSE, its tables built for the device it is given
    fn = select_attention_fn(no_drop, mask, 74, "cpu")
    q, k, v = (torch.tensor(x) for x in _qkv(74, seed=8, n=3))
    assert (fn.tables_for(16, "cpu")[2]
            is fn.tables_for(16, torch.device("cpu"))[2])
    plain = tfa.xla_reference_attention(q, k, v, torch.tensor(mask))
    _close(fn(q, k, v), plain.numpy(), FWD_TOL, FWD_TOL)


def test_attention_hook_drops_in_train_mode_only():
    """The hook runs deterministically without a generator and draws its
    Philox seed words from the 'dropout' generator in train mode."""
    mask = _mask("octo")
    fn = tfa.make_attention_fn(mask, dropout_rate=0.1)
    q, k, v = (torch.tensor(x) for x in _qkv(74, seed=4, n=3))
    plain = tfa.xla_reference_attention(q, k, v, torch.tensor(mask))
    _close(fn(q, k, v), plain.numpy(), FWD_TOL, FWD_TOL)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = fn(q, k, v, dropout_generator=g1)
    assert torch.equal(a, fn(q, k, v, dropout_generator=g2))
    assert (a - plain).abs().max() > 1e-3
    assert not torch.equal(a, fn(q, k, v, dropout_generator=g1))
