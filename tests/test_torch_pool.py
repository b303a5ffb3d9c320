"""The port's max-pool with the kernel backward, on the CPU: the plain
backward against jax.vjp of the JAX package's max_pool_hwcn (its Pallas
kernel in interpret mode), exactly, on the tie-heavy integer-cotangent
cases of tests/test_pool_vjp.py; the stride fallback; the embedder's
pool_vjp route."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.ops import pool as tpool
from multi_modal_transformers_tokenmerge_tpu.ops.pool import (
    max_pool_hwcn as jpool,
)

# tests/test_pool_vjp.py:37-43, plus the embedder's 23x23 plane
CASES = [
    (9, 9, 16, 128, (3, 3), "float32"),
    (9, 9, 16, 130, (3, 3), "bfloat16"),
    (7, 6, 24, 100, (3, 3), "float32"),
    (8, 8, 8, 64, (2, 2), "bfloat16"),
    (5, 5, 16, 128, (4, 2), "float32"),
    (23, 23, 8, 6, (3, 3), "bfloat16"),
]


def _case(h, w, c, n, window, seed=0):
    """Half-integer x (many exact ties in a window) and small integer
    cotangents, whose sums are exact even in bfloat16."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.normal(size=(h, w, c, n)) * 2.0) / 2.0).astype(
        np.float32)
    oh, ow = h - window[0] + 1, w - window[1] + 1
    g = rng.integers(1, 17, (oh, ow, c, n)).astype(np.float32)
    return x, g


def _jax_grad(x, g, window, dtype, strides=(1, 1)):
    jx = jnp.asarray(x, dtype)
    y, vjp = jax.vjp(lambda a: jpool(a, window, strides, interpret=True), jx)
    return (np.asarray(y, np.float32),
            np.asarray(vjp(jnp.asarray(g, dtype))[0], np.float32))


def _port_grad(x, g, window, dtype, strides=(1, 1), vjp="pallas"):
    tdt = getattr(torch, dtype)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    y = tpool.max_pool_hwcn(tx, window, strides, vjp=vjp)
    y.backward(torch.tensor(g).to(tdt))
    assert tx.grad.dtype == tdt
    return y.detach().float().numpy(), tx.grad.float().numpy()


@pytest.mark.parametrize("h,w,c,n,window,dtype", CASES)
def test_pool_bwd_routing_exact(h, w, c, n, window, dtype):
    """Every window's gradient lands on the first raster-order maximum, as
    in the JAX kernel: equal element for element."""
    x, g = _case(h, w, c, n, window)
    y_j, dx_j = _jax_grad(x, g, window, dtype)
    calls = tpool.pool_bwd.launches
    y_t, dx_t = _port_grad(x, g, window, dtype)
    assert tpool.pool_bwd.launches == calls      # CPU: the plain version
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(dx_t, dx_j)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("h,w,c,n,window,dtype", CASES)
def test_plain_backward_matches_jax_in_either_layout(h, w, c, n, window,
                                                     dtype, layout):
    """pool_bwd_reference on contiguous NCHW operands and on the
    channels_last ones the embedder's convolution hands the backward
    equals the JAX kernel's vjp exactly; dx keeps x's layout."""
    x, g = _case(h, w, c, n, window, seed=5)
    _, dx_j = _jax_grad(x, g, window, dtype)
    tdt = getattr(torch, dtype)
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    nchw = lambda a: torch.tensor(a).to(tdt).permute(3, 2, 0, 1) \
        .contiguous(memory_format=fmt)
    tx, tg = nchw(x), nchw(g)
    assert tpool.kernel_layout(tx)[1] == (layout == "channels_last" and c > 1)
    dx = tpool.pool_bwd(tx, tg, window)
    assert tpool.pool_bwd.last_strides == (tx.stride(), tg.stride())
    assert dx.dtype == tdt and dx.is_contiguous(memory_format=fmt)
    np.testing.assert_array_equal(dx.permute(2, 3, 1, 0).float().numpy(),
                                  dx_j)


# windows past the 8 a side of the kernel's register body: its second body
# on the card; (plane h, w, c, n, window, dtype, the JAX vjp).  At 16 x 16
# the JAX Pallas backward takes some 50 s in interpret mode on the CPU, so
# that case holds the port against max_pool_hwcn's XLA vjp
# (select_and_scatter), the tie rule the Pallas kernel reproduces; its nine
# windows keep every sum of cotangents exact in bfloat16.
WIDE_WINDOWS = [
    (12, 12, 8, 4, (9, 9), "bfloat16", "pallas"),
    (9, 14, 8, 4, (3, 12), "float32", "pallas"),
    (18, 18, 4, 4, (16, 16), "bfloat16", "xla"),
]


@functools.lru_cache(maxsize=None)
def _wide_window_case(h, w, c, n, window, dtype, jax_vjp):
    x, g = _case(h, w, c, n, window, seed=9)
    jx = jnp.asarray(x, dtype)
    y, vjp = jax.vjp(lambda a: jpool(a, window, (1, 1), vjp=jax_vjp,
                                     interpret=True), jx)
    return x, g, np.asarray(vjp(jnp.asarray(g, dtype))[0], np.float32)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("h,w,c,n,window,dtype,jax_vjp", WIDE_WINDOWS)
def test_pool_bwd_at_windows_above_8_matches_jax(h, w, c, n, window, dtype,
                                                 jax_vjp, layout):
    """The wrapper at windows above 8 a side (the card runs them on the
    kernel's second body; the CPU on the plain version) against jax.vjp of
    the JAX max_pool_hwcn, exactly, on tie-heavy half-integer x, in either
    layout."""
    x, g, dx_j = _wide_window_case(h, w, c, n, window, dtype, jax_vjp)
    tdt = getattr(torch, dtype)
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    nchw = lambda a: torch.tensor(a).to(tdt).permute(3, 2, 0, 1) \
        .contiguous(memory_format=fmt)
    dx = tpool.pool_bwd(nchw(x), nchw(g), window)
    assert dx.is_contiguous(memory_format=fmt)
    np.testing.assert_array_equal(dx.permute(2, 3, 1, 0).float().numpy(),
                                  dx_j)
    _, dx_t = _port_grad(x, g, window, dtype)
    np.testing.assert_array_equal(dx_t, dx_j)


def test_kernel_layout_copies_only_other_layouts():
    """NCHW and channels_last pass as they are; any other strides become
    NCHW."""
    x = torch.randn(2, 8, 5, 5)
    assert tpool.kernel_layout(x) == (x, False)
    cl = x.contiguous(memory_format=torch.channels_last)
    got, nhwc = tpool.kernel_layout(cl)
    assert nhwc and got.data_ptr() == cl.data_ptr()
    odd = x.permute(0, 1, 3, 2)
    got, nhwc = tpool.kernel_layout(odd)
    assert not nhwc and got.is_contiguous() and torch.equal(got, odd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_window_drops_its_gradient(dtype):
    """A window holding a NaN routes its gradient nowhere (the JAX
    kernel's rule); windows without one are unaffected."""
    x, g = _case(9, 9, 4, 8, (3, 3), seed=1)
    x[4, 4, 0, 0] = np.nan
    _, dx_j = _jax_grad(x, g, (3, 3), dtype)
    tdt = getattr(torch, dtype)
    nchw = lambda a: torch.tensor(a).to(tdt).permute(3, 2, 0, 1)
    dx_t = tpool.pool_bwd_reference(nchw(x), nchw(g), (3, 3))
    dx_t = dx_t.permute(2, 3, 1, 0).float().numpy()
    np.testing.assert_array_equal(dx_t, dx_j)
    # the nine windows covering (4, 4) route nothing in that plane
    covered = dx_t[2:7, 2:7, 0, 0]
    assert covered.sum() < dx_t[:, :, 1, 0].sum()


@pytest.mark.parametrize("strides", [(2, 2), (1, 2)])
def test_stride_falls_back_to_torch(strides, monkeypatch):
    """A stride other than 1 takes torch's own backward, as the JAX
    package falls back to XLA's; both route ties to the first maximum."""
    called = []
    monkeypatch.setattr(tpool, "pool_bwd",
                        lambda *a: called.append(1))
    x, _ = _case(9, 9, 4, 8, (3, 3), seed=2)
    oh = (9 - 3) // strides[0] + 1
    ow = (9 - 3) // strides[1] + 1
    g = np.random.default_rng(3).integers(1, 17, (oh, ow, 4, 8)).astype(
        np.float32)
    y_j, dx_j = _jax_grad(x, g, (3, 3), "float32", strides)
    y_t, dx_t = _port_grad(x, g, (3, 3), "float32", strides)
    assert not called
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(dx_t, dx_j)


def test_xla_vjp_is_torch_backward(monkeypatch):
    called = []
    monkeypatch.setattr(tpool, "pool_bwd", lambda *a: called.append(1))
    x, g = _case(9, 9, 4, 8, (3, 3), seed=4)
    _, dx_j = _jax_grad(x, g, (3, 3), "float32")
    _, dx_t = _port_grad(x, g, (3, 3), "float32", vjp="xla")
    assert not called
    np.testing.assert_array_equal(dx_t, dx_j)


def test_checks():
    with pytest.raises(ValueError):
        tpool.max_pool_hwcn(torch.zeros(4, 4, 2), (3, 3))
    with pytest.raises(ValueError):
        tpool.max_pool_nchw(torch.zeros(1, 2, 4, 4), vjp="tpu")
    meta = torch.zeros(2, 3, 23, 23, device="meta")
    with pytest.raises(RuntimeError, match="sm_90"):
        tpool.pool_bwd(meta, torch.zeros(2, 3, 21, 21, device="meta"),
                       (3, 3))
    with pytest.raises(ValueError):
        tpool.pool_bwd(torch.zeros(2, 3, 23, 23), torch.zeros(2, 3, 20, 21),
                       (3, 3))


@pytest.mark.parametrize("pool_vjp", ["pallas", "xla", "auto"])
def test_embedder_routes_pool_vjp(pool_vjp, monkeypatch):
    """pool_vjp='pallas' sends the embedder's max-pool backward through
    ops.pool; 'xla' and 'auto' ('auto' is 'xla') through torch's."""
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        ResNetEmbedderConfig,
    )
    from multi_modal_transformers_tokenmerge_torch.modules.image_tokenizer \
        import ResNetV2Embedder
    calls = []
    original = tpool.pool_bwd

    def counting(*a):
        calls.append(1)
        return original(*a)

    monkeypatch.setattr(tpool, "pool_bwd", counting)
    cfg = ResNetEmbedderConfig(num_blocks=1, features=8, input_kernel=(8, 8),
                               input_stride=(4, 4), group_norm_groups=4,
                               output_features=16, pool_vjp=pool_vjp)
    emb = ResNetV2Embedder(cfg, 32, 3)
    g = torch.Generator().manual_seed(0)
    for m in emb.modules():
        if m is not emb and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    x = torch.randn(2, 3, 32, 32, 3, generator=g)
    emb(x).sum().backward()
    assert len(calls) == (pool_vjp == "pallas")
    with pytest.raises(ValueError):
        ResNetV2Embedder(cfg.replace(pool_vjp="tpu"), 32, 3)


# -- the wide body's separable winner search, emulated ------------------------

def _round_bf16(a):
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _separable_pool_bwd(x, g, window, dtype):
    """csrc/pool_bwd.cu:pool_bwd_wide_kernel's algorithm in numpy, every
    lane (plane) at once: x (P, H, W), g (P, OH, OW) float32 holding values
    of ``dtype``.  A NaN counts as greater than every number and equal
    values as one, ties to the first.  Row pass: each row window's max and
    the column of its first maximum from suffix maxima over blocks of ww
    columns and prefix maxima over the next block; column pass: a window's
    first row holding the max of its rows' maxima, a NaN window's cotangent
    set to +0; gather: window rows from the bottom, each run of adjacent
    windows won by one pixel adding its cotangents right to left into that
    pixel's dx, each add rounded in ``dtype``.  Returns dx, the row pass's
    columns, the winning rows and each window's winning pixel."""
    wh, ww = window
    p, h, w = x.shape
    oh, ow = h - wh + 1, w - ww + 1
    nan = np.isnan
    ge = lambda a, b: (a >= b) | nan(a)             # a first on a tie
    gt = lambda a, b: (a > b) | (nan(a) & ~nan(b))  # a strictly after
    rmax = np.zeros((p, h, ow), np.float32)
    rcol = np.zeros((p, h, ow), np.int64)
    for i in range(h):
        for o0 in range(0, ow, ww):
            o1 = min(o0 + ww, ow)
            s = x[:, i, o0 + ww - 1].copy()
            sc = np.full(p, o0 + ww - 1)
            for k in range(o0 + ww - 2, o0 - 1, -1):
                if o0 < k + 1 < o1:
                    rmax[:, i, k + 1], rcol[:, i, k + 1] = s, sc
                v = x[:, i, k]
                sc = np.where(ge(v, s), k, sc)
                s = np.maximum(s, v)         # NaN wins, as max.NaN
            rmax[:, i, o0], rcol[:, i, o0] = s, sc
            pm = pc = None
            for o in range(o0 + 1, o1):
                kk = o + ww - 1
                v = x[:, i, kk]
                if pm is None:
                    pm, pc = v.copy(), np.full(p, kk)
                else:
                    pc = np.where(gt(v, pm), kk, pc)
                    pm = np.maximum(pm, v)
                sv = rmax[:, i, o]
                rcol[:, i, o] = np.where(ge(sv, pm), rcol[:, i, o], pc)
                rmax[:, i, o] = np.maximum(sv, pm)
    wrow = np.zeros((p, oh, ow), np.int64)
    g = g.copy()
    for oi in range(oh):
        m = rmax[:, oi].copy()
        r = np.full((p, ow), oi)
        for di in range(1, wh):
            v = rmax[:, oi + di]
            r = np.where(gt(v, m), oi + di, r)
            m = np.maximum(m, v)
        wrow[:, oi] = r
        g[:, oi] = np.where(nan(m), np.float32(0), g[:, oi])
    rnd = _round_bf16 if dtype == "bfloat16" else (lambda a: a)
    dx = np.zeros_like(x)
    winner = np.zeros((p, oh, ow), np.int64)
    for q in range(p):
        for oi in range(oh):
            for oj in range(ow):
                r = wrow[q, oi, oj]
                winner[q, oi, oj] = r * w + rcol[q, r, oj]
    flat = dx.reshape(p, h * w)
    for oi in range(oh - 1, -1, -1):
        for q in range(p):
            for oj in range(ow):
                pix = winner[q, oi, oj]
                if oj + 1 < ow and winner[q, oi, oj + 1] == pix:
                    continue          # not its run's rightmost window
                acc = flat[q, pix]
                o = oj
                while o >= 0 and (o == oj or winner[q, oi, o] == pix):
                    acc = rnd(np.array([acc + g[q, oi, o]], np.float32))[0]
                    o -= 1
                flat[q, pix] = acc
    return dx, rcol, wrow, winner


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [(9, 9), (3, 12), (16, 16), (23, 1)])
def test_separable_winner_rule_is_the_plain_versions(window, dtype):
    """The wide body's algorithm (emulated) against pool_bwd_reference,
    exactly, on a 23x23 plane of tie-heavy half-integer x with a NaN and
    rounding cotangents (sums that round, so the visiting order shows):
    row pass first-max column then first row, the gather's order and
    rounding; and the orders the gather relies on."""
    h = w = 23
    wh, ww = window
    rng = np.random.default_rng(wh * 100 + ww)
    n, c = 2, 3
    x = (np.round(rng.normal(size=(n, c, h, w)) * 2.0) / 2.0).astype(
        np.float32)
    x[1, 2, 11, 11] = np.nan
    g = rng.normal(size=(n, c, h - wh + 1, w - ww + 1)).astype(np.float32)
    if dtype == "bfloat16":
        g = _round_bf16(g)
    tdt = getattr(torch, dtype)
    want = tpool.pool_bwd_reference(torch.tensor(x).to(tdt),
                                    torch.tensor(g).to(tdt), window)
    got, rcol, wrow, winner = _separable_pool_bwd(
        x.reshape(n * c, h, w), g.reshape(n * c, h - wh + 1, w - ww + 1),
        window, dtype)
    np.testing.assert_array_equal(got.reshape(n, c, h, w),
                                  want.float().numpy())
    # the first maximum moves right with the window and down with it, and
    # the windows of a window row that one pixel won are adjacent
    assert (np.diff(rcol, axis=2) >= 0).all()
    assert (np.diff(wrow, axis=1) >= 0).all()
    for row in winner.reshape(-1, winner.shape[-1]):
        starts = np.r_[True, row[1:] != row[:-1]]
        assert len(np.unique(row)) == starts.sum()
    # the NaN is its windows' first maximum, in its row and its column
    lo = max(0, 11 - ww + 1)
    assert (rcol[5, 11, lo:12] == 11).all()
    # ties: windows whose max stands at more than one position
    planes = x.reshape(n * c, h, w)
    ties = sum(
        int(np.sum(win == np.nanmax(win)) > 1)
        for q in range(n * c) for oi in range(h - wh + 1)
        for oj in range(w - ww + 1)
        for win in [planes[q, oi:oi + wh, oj:oj + ww]]
        if not np.isnan(win).any())
    assert ties > 0


def _direct_winners(x, window):
    """Each window's winning pixel from its pixels in raster order, a pixel
    replacing the running one only where it is greater (a NaN greater than
    every number, the first NaN kept): the wide body's search where its
    row arrays do not fit.  x (P, H, W) -> (P, OH, OW) pixel indices."""
    wh, ww = window
    p, h, w = x.shape
    oh, ow = h - wh + 1, w - ww + 1
    nan = np.isnan
    m = x[:, :oh, :ow].copy()
    pix = np.broadcast_to(np.arange(oh)[:, None] * w + np.arange(ow),
                          (p, oh, ow)).copy()
    for di in range(wh):
        for dj in range(1 if di == 0 else 0, ww):
            v = x[:, di:di + oh, dj:dj + ow]
            take = (v > m) | (nan(v) & ~nan(m))
            pix = np.where(take, (np.arange(oh)[:, None] + di) * w
                           + np.arange(ow) + dj, pix)
            m = np.maximum(m, v)
    return pix


@pytest.mark.parametrize("window", [(9, 9), (3, 12), (16, 16), (23, 1)])
def test_direct_search_names_the_separable_winners(window):
    """The wide body's two searches name the same winner in every window:
    the separable one (row pass, column pass; emulated above) and the one
    reading each window whole, on tie-heavy data with NaNs."""
    h = w = 23
    rng = np.random.default_rng(7 * window[0] + window[1])
    x = (np.round(rng.normal(size=(6, h, w)) * 2.0) / 2.0).astype(np.float32)
    x[1, 11, 11] = x[4, 3, 20] = x[4, 17, 2] = np.nan
    g = np.zeros((6, h - window[0] + 1, w - window[1] + 1), np.float32)
    winner = _separable_pool_bwd(x, g, window, "float32")[3]
    np.testing.assert_array_equal(_direct_winners(x, window), winner)


def _slot_body_smem(c, h, w, window, elem):
    """The shared memory the wide body took at its least chunk before the
    row arrays (x, g and one array of winners at one lane group a
    position), or None where the chunk the launch settled on did not fit:
    the planes that body took."""
    wh, ww = window
    lanes = 1 if elem == 4 else 2
    a16 = lambda n: (n + 15) & ~15
    need = -(-c // lanes) * lanes
    cb = min(32 // elem, need)
    size = lambda cb: (a16(h * w * cb * elem)
                       + 2 * a16((h - wh + 1) * (w - ww + 1) * cb * elem))
    while size(cb) > 227 * 1024 and cb > lanes:
        cb = (cb // 2 + lanes - 1) // lanes * lanes
    return size(cb) if size(cb) <= 227 * 1024 else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("window", [(9, 9), (3, 12), (16, 16), (23, 1),
                                    (9, 40)])
def test_wide_plan_takes_every_plane_the_slot_body_took(window, dtype):
    """kernel_plan (the mirror of the launch's plan_chunk; phase 2 holds it
    against the library's) refuses no plane the wide body took before its
    row arrays: every square and a band of rectangles up to past the
    largest, at 3 and 64 channels.  The separable search is taken where
    its arrays fit; elsewhere the direct search, in that body's footprint
    and never more shared memory than it; the 23x23 plane of the main path
    keeps the separable search at 32 bytes of channels."""
    elem = torch.empty((), dtype=dtype).element_size()
    wh, ww = window
    planes = [(s, s) for s in range(max(wh, ww), 200)]
    planes += [(s, 2 * s) for s in range(max(wh, ww // 2 + 1), 140, 3)]
    planes += [(2 * s, s) for s in range(max(wh // 2 + 1, ww), 140, 3)]
    took = kept = direct = 0
    for c in (3, 64):
        for h, w in planes:
            if h < wh or w < ww:
                continue
            old = _slot_body_smem(c, h, w, window, elem)
            plan = tpool.kernel_plan(c, h, w, window, dtype)
            if old is None:
                continue
            took += 1
            assert plan is not None, (c, h, w)
            assert plan["wide"] and plan["smem_bytes"] <= 227 * 1024
            if plan["rows"]:
                kept += 1
            else:
                direct += 1
                assert plan["smem_bytes"] == old
    assert took > 100 and kept > 0 and direct > 0
    main = tpool.kernel_plan(64, 23, 23, window, dtype) if ww <= 23 else None
    if main is not None:
        assert main["rows"] and main["cb"] == 32 // elem
