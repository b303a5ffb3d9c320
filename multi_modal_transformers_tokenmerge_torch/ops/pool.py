"""Stride-1 VALID max-pool whose backward is a CUDA kernel: the wrapper,
its plain PyTorch version and the autograd function.

Counterpart of the JAX package's ``ops/pool.py`` (Pallas kernel
``_pool_bwd_kernel``).  The forward is ``F.max_pool2d``, as the JAX
forward is XLA's ``reduce_window`` outside Pallas.  The backward routes
each window's gradient to the FIRST position in raster order equal to the
window's float32 max (the tie rule of XLA's ``select_and_scatter``); a
window holding a NaN drops its gradient, as the JAX kernel does.  The
kernel, ``csrc/pool_bwd.cu``, reads x and g each in the layout it is
handed, NCHW or channels_last (the embedder's convolution hands it
channels_last), and writes dx in x's, at any window (up to 8 a side on
the body the 3x3 window is compiled into, wider ones on a second body); its
source note says what bounds it.

:func:`max_pool_nchw` is the core the NCHW image embedder calls;
:func:`max_pool_hwcn` keeps the JAX signature on (H, W, C, N) operands.
``vjp='xla'`` (and any stride other than 1, as in the JAX package) takes
torch's own max-pool backward.  :func:`pool_bwd` runs
:func:`pool_bwd_reference` for CPU tensors, launches the kernel on an sm_90
card and raises otherwise; ``pool_bwd.launches`` counts kernel launches
and ``pool_bwd.last_strides`` holds the strides of the last call's x and g.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..core.hw import on_cuda

__all__ = ["kernel_layout", "kernel_plan", "max_pool_hwcn", "max_pool_nchw",
           "pool_bwd", "pool_bwd_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _slots(window, out_hw):
    """(row slice, col slice) of every window slot, in raster order."""
    (wh, ww), (oh, ow) = window, out_hw
    return [(slice(di, di + oh), slice(dj, dj + ow))
            for di in range(wh) for dj in range(ww)]


def pool_bwd_reference(x: torch.Tensor, g: torch.Tensor,
                       window: Tuple[int, int]) -> torch.Tensor:
    """Plain version of the kernel on NCHW: x (N, C, H, W), g (N, C, OH,
    OW) -> dx like x.  The window max is recomputed in float32; slots
    claim in raster order, a claimed window is poisoned with NaN so no
    later slot matches, and dx accumulates in x's dtype slot by slot."""
    h, w = x.shape[-2:]
    oh, ow = h - window[0] + 1, w - window[1] + 1
    slots = _slots(window, (oh, ow))
    y = torch.full(g.shape, -float("inf"), dtype=torch.float32,
                   device=x.device)
    for rs, cs in slots:
        y = torch.maximum(y, x[..., rs, cs].float())
    dx = torch.zeros_like(x)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for rs, cs in slots:
        sel = x[..., rs, cs].float() == y
        dx[..., rs, cs] = dx[..., rs, cs] + torch.where(sel, g, zero)
        y = torch.where(sel, float("nan"), y)
    return dx


def kernel_layout(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(t, True) for a dense channels_last tensor, (t, False) for a
    contiguous NCHW one; anything else is copied to NCHW first.  The two
    layouts the kernel reads; NCHW where a tensor is both."""
    if t.is_contiguous():
        return t, False
    if t.is_contiguous(memory_format=torch.channels_last):
        return t, True
    return t.contiguous(), False


def _library():
    lib = _build.load_library("pool_bwd")
    if not getattr(lib, "_signatures_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pool_bwd_launch.argtypes = [vp] * 3 + [ci] * 9 + [vp]
        lib.pool_bwd_launch.restype = ci
        lib.pool_bwd_plan.argtypes = [ci] * 6 + [vp]
        lib.pool_bwd_plan.restype = ci
        lib.pool_bwd_error_string.argtypes = [ci]
        lib.pool_bwd_error_string.restype = ctypes.c_char_p
        lib._signatures_set = True
    return lib


# csrc/pool_bwd.cu's cut of a launch: a block's channels at one pixel, the
# card's shared memory a block, the register body's largest window side
_CHUNK_BYTES = 32
_SMEM_MAX = 227 * 1024
_MAX_WINDOW = 8


def _smem_bytes(h, w, oh, ow, cb, elem, rows):
    a16 = lambda n: (n + 15) & ~15
    at = cb * elem
    return (a16(h * w * at) + 2 * a16(oh * ow * at)
            + (2 * h * ow * at if rows else 0))


def kernel_plan(c: int, h: int, w: int, window: Tuple[int, int],
                dtype: torch.dtype):
    """How the kernel cuts a launch on c channels of an h x w plane, as
    ``plan_chunk`` in ``csrc/pool_bwd.cu`` does: ``wide`` (the second body,
    windows above 8 a side), ``rows`` (its separable search, whose row
    maxima and their columns take 2 h ow positions beside the plane; else
    it reads each window whole in the register body's footprint), ``cb``
    (the channels a block: 32 bytes of them, halved to one lane group until
    the block's shared memory fits) and ``smem_bytes``.  None where not even
    one lane group fits: the launch refuses the shape."""
    wh, ww = window
    elem = torch.empty((), dtype=dtype).element_size()
    lanes = 1 if elem == 4 else 2
    oh, ow = h - wh + 1, w - ww + 1
    need = -(-c // lanes) * lanes
    wide = wh > _MAX_WINDOW or ww > _MAX_WINDOW
    for rows in ((True, False) if wide else (False,)):
        cb = min(_CHUNK_BYTES // elem, need)
        smem = _smem_bytes(h, w, oh, ow, cb, elem, rows)
        while smem > _SMEM_MAX and cb > lanes:
            cb = (cb // 2 + lanes - 1) // lanes * lanes
            smem = _smem_bytes(h, w, oh, ow, cb, elem, rows)
        if smem <= _SMEM_MAX:
            return dict(wide=wide, rows=rows, cb=cb, smem_bytes=smem)
    return None


def library_plan(c: int, h: int, w: int, window: Tuple[int, int],
                 dtype: torch.dtype):
    """The kernel library's own cut (``pool_bwd_plan``), in
    :func:`kernel_plan`'s keys, or None where it refuses the shape.  Needs
    the built library (the card's machine)."""
    out = (ctypes.c_longlong * 4)()
    rc = _library().pool_bwd_plan(c, h, w, *window, _DTYPE_CODES[dtype],
                                  out)
    if rc != 0:
        return None
    return dict(wide=bool(out[0]), rows=bool(out[1]), cb=int(out[2]),
                smem_bytes=int(out[3]))


def pool_bwd(x: torch.Tensor, g: torch.Tensor,
             window: Tuple[int, int]) -> torch.Tensor:
    """Max-pool backward (stride 1, VALID) on NCHW shapes; arguments as
    for :func:`pool_bwd_reference`.  CPU tensors take the plain version; on
    a CUDA device this launches the kernel or raises.  The kernel reads x
    and g as they are laid out (:func:`kernel_layout`) and dx comes back in
    x's layout."""
    wh, ww = (int(v) for v in window)
    n, c, h, w = x.shape
    if tuple(g.shape) != (n, c, h - wh + 1, w - ww + 1):
        raise ValueError(f"pool_bwd: g {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)} under window {(wh, ww)}")
    pool_bwd.last_strides = (tuple(x.stride()), tuple(g.stride()))
    if x.device.type == "cpu":
        return pool_bwd_reference(x, g, (wh, ww))
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise ValueError(f"pool_bwd: dtypes {x.dtype}/{g.dtype}; the kernel "
                         f"takes one of {sorted(map(str, _DTYPE_CODES))}")
    if not (1 <= wh <= h and 1 <= ww <= w):
        raise ValueError(f"pool_bwd: window {(wh, ww)} does not fit the "
                         f"{h}x{w} plane")
    if not on_cuda(x, g):
        raise RuntimeError("pool_bwd: the kernel needs both tensors on one "
                           f"sm_90 CUDA device; got {x.device}, {g.device}")
    (x, x_nhwc), (g, g_nhwc) = kernel_layout(x), kernel_layout(g)
    dx = torch.empty_like(x, memory_format=torch.channels_last if x_nhwc
                          else torch.contiguous_format)
    lib = _library()
    rc = lib.pool_bwd_launch(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, c, h, w, wh, ww,
        int(x_nhwc), int(g_nhwc), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("pool_bwd kernel launch failed: "
                           f"{lib.pool_bwd_error_string(rc).decode()}")
    pool_bwd.launches += 1
    return dx


pool_bwd.launches = 0
pool_bwd.last_strides = None


class _MaxPool(torch.autograd.Function):
    """``F.max_pool2d`` forward (stride 1), :func:`pool_bwd` backward."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.save_for_backward(x)
        ctx.window = window
        return F.max_pool2d(x, window, stride=1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pool_bwd(x, g, ctx.window), None


def max_pool_nchw(x: torch.Tensor, window=(3, 3), strides=(1, 1), *,
                  vjp: str = "pallas") -> torch.Tensor:
    """VALID max-pool of an NCHW tensor.  ``vjp='pallas'`` at stride 1
    differentiates through the kernel; ``'xla'`` or another stride takes
    torch's own backward."""
    window = tuple(int(v) for v in window)
    strides = tuple(int(v) for v in strides)
    if vjp not in ("pallas", "xla"):
        raise ValueError(f"unknown pool vjp {vjp!r}")
    if vjp == "pallas" and strides == (1, 1):
        return _MaxPool.apply(x, window)
    return F.max_pool2d(x, window, strides)


def max_pool_hwcn(x: torch.Tensor, window=(3, 3), strides=(1, 1), *,
                  vjp: str = "pallas") -> torch.Tensor:
    """VALID max-pool over dims (0, 1) of a 4-D (H, W, C, N) tensor, the
    JAX package's signature: a permute around :func:`max_pool_nchw`."""
    if x.ndim != 4:
        raise ValueError(f"max_pool_hwcn expects a 4-D (H, W, C, N) "
                         f"tensor, got shape {tuple(x.shape)}")
    y = max_pool_nchw(x.permute(3, 2, 0, 1), window, strides, vjp=vjp)
    return y.permute(2, 3, 1, 0)
