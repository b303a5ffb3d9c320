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
