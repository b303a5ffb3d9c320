"""The image tower's GroupNorm, its affine and the tanh GELU as two CUDA
kernels: the wrapper, its plain PyTorch version and the custom op.

The JAX package computes this step with XLA (``group_norm_stats_hwcn``
then ``nn.gelu``); no Pallas kernel stands behind it.  On the card the
plain chain (``PatchGroupNorm.forward`` then ``F.gelu``) ran as some 15
float32 passes over each block's map; ``csrc/group_norm_gelu.cu`` does the
same work in one pass that reads the map for the statistics and one that
reads it again and writes the result, and its source note says what bounds
it.

:func:`group_norm_gelu` takes x (N, C, H, W), N = elements x
``patches_per_element``: statistics per (element, group) over the
element's patches (``norm_stats_scope='image'``; 1 patch an element is the
``'patch'`` scope), float32, with the clamped E[x^2] - mu^2 variance; then
``((x - mu) * rstd) * weight + bias`` rounded to ``dtype`` and the tanh
GELU, rounded again, as the plain chain rounds.  It runs
:func:`group_norm_gelu_reference` for CPU tensors, launches the kernels on
an sm_90 card and raises otherwise; the kernels read x in the layout it is
handed (``ops.pool.kernel_layout``: channels_last or NCHW) and y comes back
in that layout.  ``group_norm_gelu.launches`` counts the calls that
launched the kernel pair.  Outside autograd the embedder reaches it through
the custom op ``tokenmerge::group_norm_gelu`` (:func:`group_norm_gelu_op`),
the name an exported program holds; where autograd records, through
:class:`GroupNormGelu`, whose forward is the same kernels (keeping each
element's mean and variance) and whose backward,
:func:`group_norm_gelu_backward`, is plain PyTorch from those statistics.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..core.hw import on_cuda
from .pool import kernel_layout

__all__ = ["GroupNormGelu", "group_norm_gelu", "group_norm_gelu_backward",
           "group_norm_gelu_op", "group_norm_gelu_reference",
           "library_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def group_norm_gelu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float, patches_per_element: int,
                              dtype: torch.dtype) -> torch.Tensor:
    """The plain chain on any device: ``group_norm_stats`` in float32, the
    float32 affine, the cast to ``dtype``, ``F.gelu(approximate='tanh')``."""
    # imported here: the embedder's module imports this one
    from ..modules.image_tokenizer import group_norm_stats
    f = group_norm_stats(x.float(), num_groups, eps, "image",
                         patches_per_element)
    f = f * weight.float()[:, None, None] + bias.float()[:, None, None]
    return F.gelu(f.to(dtype), approximate="tanh")


def _library():
    lib = _build.load_library("group_norm_gelu")
    if not getattr(lib, "_signatures_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gn_plan.argtypes = [ci] * 8 + [vp]
        lib.gn_plan.restype = ci
        lib.gn_launch.argtypes = ([vp] * 6 + [ci] * 6 + [ctypes.c_float]
                                  + [ci] * 2 + [vp])
        lib.gn_launch.restype = ci
        lib.gn_error_string.argtypes = [ci]
        lib.gn_error_string.restype = ctypes.c_char_p
        lib._signatures_set = True
    return lib


def library_plan(shape, num_groups: int, patches_per_element: int,
                 nhwc: bool, dtype: torch.dtype):
    """The kernels' cut of a launch on x of ``shape`` (``gn_plan``): elements
    a load, threads a block, rows an element (pixels in NHWC, planes in
    NCHW), rows a chunk, chunks an element; None where the shape is
    refused.  Needs the built library (the card's machine)."""
    n, c, h, w = (int(v) for v in shape)
    out = (ctypes.c_longlong * 5)()
    rc = _library().gn_plan(n, c, h, w, num_groups, patches_per_element,
                            int(nhwc), _DTYPE_CODES[dtype], out)
    if rc != 0:
        return None
    return dict(zip(("vec", "threads", "rows", "rows_per_chunk", "chunks"),
                    (int(v) for v in out)))


def _check(x, weight, bias, num_groups, patches_per_element):
    if x.ndim != 4:
        raise ValueError(f"group_norm_gelu: x must be (N, C, H, W), got "
                         f"shape {tuple(x.shape)}")
    n, c = x.shape[:2]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"group_norm_gelu: {c} channels not divisible "
                         f"into {num_groups} groups")
    if patches_per_element < 1 or n % patches_per_element:
        raise ValueError(f"group_norm_gelu: a batch of {n} patches is not "
                         f"divisible into elements of {patches_per_element}")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group_norm_gelu: weight {tuple(weight.shape)} "
                         f"and bias {tuple(bias.shape)} must be ({c},)")


def group_norm_gelu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, num_groups: int, eps: float,
                    patches_per_element: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm -> affine -> tanh GELU of x (N, C, H, W) with statistics
    over each element's ``patches_per_element`` patches; arguments as for
    :func:`group_norm_gelu_reference`.  CPU tensors take the plain version;
    on a CUDA device this launches the kernels or raises."""
    _check(x, weight, bias, num_groups, patches_per_element)
    if x.device.type == "cpu":
        return group_norm_gelu_reference(x, weight, bias, num_groups, eps,
                                         patches_per_element, dtype)
    return _launch(x, weight, bias, num_groups, eps, patches_per_element,
                   dtype)[0]


def _launch(x, weight, bias, num_groups, eps, patches_per_element, dtype,
            with_stats=False):
    """The kernels on checked arguments: y, and with ``with_stats`` the
    (elements, groups, 2) float32 mean and variance they computed (else
    None)."""
    if x.dtype not in _DTYPE_CODES or dtype != x.dtype:
        raise ValueError(f"group_norm_gelu: x {x.dtype} into {dtype}; the "
                         f"kernels take one of "
                         f"{sorted(map(str, _DTYPE_CODES))} into itself")
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    if not on_cuda(x, weight, bias):
        raise RuntimeError("group_norm_gelu: the kernels need x, weight and "
                           "bias on one sm_90 CUDA device; got "
                           f"{x.device}, {weight.device}, {bias.device}")
    x, nhwc = kernel_layout(x)
    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last if nhwc
                    else torch.contiguous_format)
    n, c, h, w = x.shape
    plan = library_plan(x.shape, num_groups, patches_per_element, nhwc,
                        x.dtype)
    if plan is None:
        raise ValueError(f"group_norm_gelu: the kernels refuse x "
                         f"{tuple(x.shape)} in {num_groups} groups at "
                         f"{patches_per_element} patches an element")
    elements = n // patches_per_element
    part = torch.empty((elements, plan["chunks"], num_groups, 2),
                       dtype=torch.float32, device=x.device)
    stats = (torch.empty((elements, num_groups, 2), dtype=torch.float32,
                         device=x.device) if with_stats else None)
    y = torch.empty_like(x, memory_format=torch.channels_last if nhwc
                         else torch.contiguous_format)
    lib = _library()
    rc = lib.gn_launch(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part.data_ptr(), None if stats is None else stats.data_ptr(), n,
        c, h, w, num_groups,
        patches_per_element, eps, int(nhwc), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("group_norm_gelu kernel launch failed: "
                           f"{lib.gn_error_string(rc).decode()}")
    group_norm_gelu.launches += 1
    return y, stats


group_norm_gelu.launches = 0


def group_norm_gelu_backward(gy, x, weight, bias, stats, num_groups, eps,
                             patches_per_element, dtype):
    """The gradients (dx, dweight, dbias) of :func:`group_norm_gelu` at x,
    given gy and the (elements, groups, 2) mean and clamped variance of its
    forward, in plain PyTorch on any device.

    The plain chain's backward written out, in float32 (or x's dtype where
    wider): z = ((x - mu) * rstd) * w + b rounded to ``dtype``, the GELU's
    gradient at z in ``dtype`` (``aten.gelu_backward``, as autograd takes
    it through ``F.gelu``), then with g that gradient in float32 and xhat =
    (x - mu) * rstd: dbias = sum g, dweight = sum g * xhat over patches and
    pixels, and over each element's group dx = rstd * (g w - mean(g w) -
    xhat * mean(g w xhat)), the last term dropped where the variance was
    clamped to zero (``clamp_min`` passes no gradient there).  dx comes back
    in x's dtype, dweight and dbias in theirs."""
    n, c, h, w = x.shape
    e, g = n // patches_per_element, num_groups
    acc = torch.promote_types(x.dtype, torch.float32)

    def grouped(t):
        # (N, C, H, W) -> (E, P, G, C / G, H, W): views, any strides
        return t.unflatten(1, (g, c // g)).unflatten(0, (e, -1))

    def per_channel(t):
        return t.to(acc).reshape(1, 1, g, c // g, 1, 1)

    shape = (e, 1, g, 1, 1, 1)
    mu = stats[..., 0].to(acc).reshape(shape)
    var = stats[..., 1].to(acc).reshape(shape)
    rstd = torch.rsqrt(var + eps)
    xhat = (grouped(x.to(acc)) - mu) * rstd
    z = (xhat * per_channel(weight) + per_channel(bias)).to(dtype)
    gz = torch.ops.aten.gelu_backward(grouped(gy.to(dtype)), z,
                                      approximate="tanh").to(acc)
    reduce = (0, 1, 4, 5)
    dweight = (gz * xhat).sum(reduce).reshape(c).to(weight.dtype)
    dbias = gz.sum(reduce).reshape(c).to(bias.dtype)
    gx = gz * per_channel(weight)
    dims = (1, 3, 4, 5)
    m1 = gx.mean(dims, keepdim=True)
    m2 = (gx * xhat).mean(dims, keepdim=True) * (var > 0)
    dx = rstd * (gx - m1 - xhat * m2)
    return dx.flatten(0, 1).flatten(1, 2).to(x.dtype), dweight, dbias


class GroupNormGelu(torch.autograd.Function):
    """:func:`group_norm_gelu` where autograd records: the forward launches
    the kernels (CUDA tensors only) and keeps x and each element's (mu,
    var); the backward is :func:`group_norm_gelu_backward`."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, patches_per_element,
                dtype):
        _check(x, weight, bias, num_groups, patches_per_element)
        y, stats = _launch(x, weight, bias, num_groups, eps,
                           patches_per_element, dtype, with_stats=True)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.args = (num_groups, eps, patches_per_element, dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dw, db = group_norm_gelu_backward(gy, x, weight, bias, stats,
                                              *ctx.args)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None, None, None, None)


@torch.library.custom_op("tokenmerge::group_norm_gelu", mutates_args=())
def group_norm_gelu_op(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, num_groups: int, eps: float,
                       patches_per_element: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """:func:`group_norm_gelu` as the custom op
    ``tokenmerge::group_norm_gelu``, the name an exported program
    (``serve.export``) holds; the embedder calls it."""
    return group_norm_gelu(x, weight, bias, num_groups, eps,
                           patches_per_element, dtype)


@group_norm_gelu_op.register_fake
def _(x, weight, bias, num_groups, eps, patches_per_element, dtype):
    _check(x, weight, bias, num_groups, patches_per_element)
    nhwc = (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))
    return torch.empty_like(x, dtype=dtype, memory_format=(
        torch.channels_last if nhwc else torch.contiguous_format))
