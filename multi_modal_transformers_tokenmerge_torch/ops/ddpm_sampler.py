"""Fused DDPM / DDIM reverse sampler: the CUDA kernels' wrapper and their
plain PyTorch version.

Counterpart of the JAX package's ``ops/ddpm_sampler.py:fused_ddpm_sample``
(Pallas kernel ``_sampler_kernel``), which takes any action dim, hidden
width, step count and batch.  Two kernels run the whole T-step reverse loop
of a ``num_blocks == 1`` denoiser in one launch:

- the register kernel, ``csrc/ddpm_sampler.cu``: one block a batch row,
  each thread's weights in float32 registers, all T steps' contexts staged
  in shared memory; it takes A <= 16, H <= :func:`register_max_hidden`
  and T·H contexts that fit one block's shared memory (octo_base's shape);
- the wide kernel, ``csrc/ddpm_sampler_wide.cu``: a cluster of up to 8
  blocks splits the hidden units, each block's slice of the weights in
  shared memory, up to 8 batch rows a block, the partial sums exchanged by
  ``st.async`` on each block's mbarrier, the contexts and noise streamed
  through a ring of shared-memory stages; it takes every shape
  (:func:`wide_sampler_plan` mirrors how it cuts one).

:func:`sampler_variant` chooses between them from the shape alone; each
source note says what bounds its kernel and how the design answers.

:func:`ddpm_sampler` runs :func:`ddpm_sample_reference` for CPU tensors,
launches a kernel for tensors on an sm_90 card, and raises for anything
else.  ``ddpm_sampler.launches`` counts kernel launches, and
``ddpm_sampler.by_variant[v].launches`` those of each kernel.
:func:`ddpm_sampler_op` is the same function registered as the custom op
``tokenmerge::ddpm_sampler`` (with a shape function for tracing), so that
``torch.export`` can carry it.

Weights come in ``torch.nn.Linear`` layout: ``wn`` (H, A) and ``wo``
(A, H), so ``h = x @ wn.T`` and ``eps = h @ wo.T``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..core.hw import on_cuda

__all__ = ["ddpm_sampler", "ddpm_sampler_op", "ddpm_sample_reference",
           "sampler_variant", "register_max_hidden", "REGISTER_MAX_ACTION_DIM",
           "VARIANTS", "wide_sampler_plan"]

VARIANTS = ("register", "wide")
REGISTER_MAX_ACTION_DIM = 16   # kMaxA in csrc/ddpm_sampler.cu
_MAX_SMEM_BYTES = 232448       # a block's shared memory on sm_90
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def register_max_hidden(adim: int) -> int:
    """The widest hidden layer the register kernel holds in registers at
    action dim ``adim`` (``ddpm_sampler_max_hidden`` in its source): 256
    threads of 6 units at A <= 8, of 3 at 9 <= A <= 16."""
    return 256 * (6 if adim <= 8 else 3)


def register_smem_bytes(steps: int, hidden: int, adim: int,
                        elem: int) -> int:
    """Shared memory of one register-kernel block (``smem_bytes`` in its
    source): every step's contexts, coefficients and noise, and the warps'
    partial sums, the action width padded to 8 or 16."""
    ma = 8 if adim <= 8 else 16
    return (-(-steps * hidden * elem // 16) * 16
            + 4 * (steps * (4 + ma) + 2 * 8 * ma))


def _register_takes(steps, hidden, adim, elem) -> bool:
    return (adim <= REGISTER_MAX_ACTION_DIM
            and hidden <= register_max_hidden(adim)
            and register_smem_bytes(steps, hidden, adim, elem)
            <= _MAX_SMEM_BYTES)


def sampler_variant(steps: int, batch: int, hidden: int, adim: int,
                    dtype: torch.dtype) -> str:
    """The kernel a shape launches: ``'register'`` where the register
    kernel takes it, ``'wide'`` for every other shape."""
    elem = torch.empty((), dtype=dtype).element_size()
    return "register" if _register_takes(steps, hidden, adim, elem) else "wide"


def _mode(ddim_x0clip: bool, ddim_eps_recompute: bool) -> int:
    if ddim_eps_recompute and not ddim_x0clip:
        raise ValueError("ddim_eps_recompute requires ddim_x0clip")
    return 0 if not ddim_x0clip else (2 if ddim_eps_recompute else 1)


def ddpm_sample_reference(noisy, contexts, noise, coeffs, wn, bn, wo, bo, *,
                          clip_value: float, ddim_x0clip: bool = False,
                          ddim_eps_recompute: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step by step.

    noisy (B, A) f32; contexts (T, B, H) in the compute dtype; noise
    (T, B, A) f32 (DDPM only, may be None for DDIM); coeffs (T, 3) rows
    (c1, c2, c3) or, with ``ddim_x0clip``, (T, 4) rows (d1, d2, e1, e2).
    Products see compute-dtype inputs and float32 sums; the state update
    is float32.  Returns (B, A) f32."""
    mode = _mode(ddim_x0clip, ddim_eps_recompute)
    cd = contexts.dtype
    wn32 = wn.to(cd).float()
    wo32 = wo.to(cd).float()
    bn_c, bo_c = bn.to(cd), bo.to(cd)
    coeffs = coeffs.float()
    sample = noisy.float()
    for t in range(contexts.shape[0]):
        x = sample.to(cd).float()
        h = torch.relu((x @ wn32.T).to(cd) + bn_c + contexts[t])
        eps = ((h.float() @ wo32.T).to(cd) + bo_c).float()
        c = coeffs[t]
        if mode == 0:
            sample = c[0] * (sample - c[1] * eps) + c[2] * noise[t]
        else:
            x0 = torch.clamp(c[0] * sample - c[1] * eps, -clip_value,
                             clip_value)
            if mode == 2:
                eps = (c[0] * sample - x0) / c[1]
            sample = c[2] * x0 + c[3] * eps
        sample = torch.clamp(sample, -clip_value, clip_value)
    return sample


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")


def _launch(noisy, contexts, noise, coeffs, wn, bn, wo, bo, clip_value,
            mode, variant) -> torch.Tensor:
    steps, batch, hidden = contexts.shape
    adim = noisy.shape[-1]
    cd = contexts.dtype
    if cd not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute dtype {cd}")
    wn, bn, wo, bo = (w.to(cd).contiguous() for w in (wn, bn, wo, bo))
    contexts = contexts.contiguous()
    noisy = noisy.float().contiguous()
    coeffs = coeffs.float().contiguous()
    _check("noisy", noisy, (batch, adim), torch.float32)
    _check("coeffs", coeffs, (steps, 3 if mode == 0 else 4), torch.float32)
    _check("wn", wn, (hidden, adim), cd)
    _check("bn", bn, (hidden,), cd)
    _check("wo", wo, (adim, hidden), cd)
    _check("bo", bo, (adim,), cd)
    if mode == 0:
        noise = noise.float().contiguous()
        _check("noise", noise, (steps, batch, adim), torch.float32)
    tensors = [noisy, contexts, coeffs, wn, bn, wo, bo]
    if mode == 0:
        tensors.append(noise)
    if not on_cuda(*tensors):
        raise RuntimeError(
            "ddpm_sampler: the kernel needs all tensors on one sm_90 CUDA "
            f"device; got {sorted({str(t.device) for t in tensors})}")

    if variant is None:
        variant = sampler_variant(steps, batch, hidden, adim, cd)
    elem = contexts.element_size()
    if variant == "register" and not _register_takes(steps, hidden, adim,
                                                      elem):
        raise ValueError(
            f"ddpm_sampler: the register kernel does not take T={steps}, "
            f"H={hidden}, A={adim} in {cd}")
    name = "ddpm_sampler" if variant == "register" else "ddpm_sampler_wide"
    lib = _library(name)
    stream, sms = _device_facts(noisy.device)
    out = torch.empty_like(noisy)
    ptrs = (noisy.data_ptr(), contexts.data_ptr(),
            noise.data_ptr() if mode == 0 else None, coeffs.data_ptr(),
            wn.data_ptr(), bn.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr())
    if variant == "register":
        rc = lib.ddpm_sampler_launch(
            *ptrs, steps, batch, hidden, adim, float(clip_value),
            _DTYPE_CODES[cd], mode, stream)
    else:
        plan = wide_plan(lib, steps, batch, hidden, adim, elem, mode, sms)
        scratch = (torch.empty(plan["scratch_floats"], dtype=torch.float32,
                               device=noisy.device)
                   if plan["scratch_floats"] else None)
        rc = lib.ddpm_sampler_wide_launch(
            *ptrs, None if scratch is None else scratch.data_ptr(), steps,
            batch, hidden, adim, float(clip_value), _DTYPE_CODES[cd], mode,
            sms, stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"ddpm_sampler {variant} kernel launch failed: "
                           f"{msg}")
    ddpm_sampler.launches += 1
    ddpm_sampler.by_variant[variant].launches += 1
    return out


_PLAN_KEYS = ("clusters", "units", "rows", "groups", "grid_y", "g1", "g2",
              "flags", "smem_bytes", "scratch_floats", "blocks",
              "expect_bytes", "threads", "bulk", "xs_rs", "hs_seg")

# csrc/ddpm_sampler_wide.cu's constants
_WIDE_THREADS = 384          # kThreads
_WIDE_ORDER_THREADS = 256    # kOrderThreads: the sum orders' split
_WIDE_MAX_ROWS = 8
_WIDE_MAX_CLUSTER = 8
_WIDE_STAGES = 4
_WIDE_WEIGHT_SHARE = 160 * 1024
_WIDE_MAX_GRID_Y = 65535


def wide_sampler_plan(steps: int, batch: int, hidden: int, adim: int,
                      elem: int, mode: int, sms: int) -> dict:
    """How the wide kernel cuts a launch, as ``make_plan`` in
    ``csrc/ddpm_sampler_wide.cu`` does, from the shape alone (``elem`` the
    compute dtype's bytes, ``mode`` 0 DDPM / 1-2 DDIM, ``sms`` the card's
    SM count), in :func:`wide_plan`'s keys: C blocks a cluster of U hidden
    units each; rows a block; the lanes sharing a sum in each product (a
    256-thread split: the sum orders); the buffers placed in shared memory
    in the order partial sums (after the exchange's two barriers), sample
    (rows of ``xs_rs`` floats: A rounded up to a 16-byte vector of the
    compute dtype's elements, 4 or 8, which the first product reads),
    hidden layer (lane-major: g2 segments of ``hs_seg`` floats, units / g2
    rounded up to such a vector, then to an odd count of 16-byte vectors,
    each read by the second product in vectors), biases, a
    ring of 4 stages (after their 4 barriers), weights (Wn rows and Wo's
    lane segments padded the same way); the bytes a barrier phase awaits
    (C slots of rows x A float32 sums, where the sums sit in shared memory
    and C > 1, else 0: a cluster or block barrier); ``bulk``, 1 where every
    row a ring stage copies starts and ends on 16 bytes, so that one thread
    copies a stage by cp.async.bulk (a launch whose contexts or noise are
    not 16-byte aligned copies per thread instead); the scratch floats of
    what does not fit."""
    cdiv = lambda a, b: -(-a // b)
    a16 = lambda n: (n + 15) & ~15
    h, a = hidden, adim
    c = max(cdiv(h, _WIDE_ORDER_THREADS), cdiv(2 * h * a * elem,
                                                _WIDE_WEIGHT_SHARE))
    c = min(c, _WIDE_MAX_CLUSTER)
    units = cdiv(cdiv(h, c), 8) * 8
    clusters = cdiv(h, units)

    def lanes_log2(n, k):
        lg = 0
        while (lg < 5 and (2 << lg) * n <= _WIDE_ORDER_THREADS
               and (2 << lg) <= k):
            lg += 1
        return lg

    slots = max(sms // clusters, 1)
    rows = 1
    while rows < _WIDE_MAX_ROWS and rows < cdiv(batch, slots):
        rows *= 2
    groups = cdiv(batch, rows)
    grid_y = min(groups, _WIDE_MAX_GRID_Y)
    lg1, lg2 = lanes_log2(units, a), lanes_log2(a, units)
    g2, vec = 1 << lg2, 16 // elem

    def odd_vectors(n, per):   # padded to an odd count of 16-byte vectors
        v = cdiv(n, per)
        return (v + 1 - v % 2) * per

    xs_rs = cdiv(a, vec) * vec                     # a sample row
    hs_seg = odd_vectors(cdiv(cdiv(units, g2), vec) * vec, 4)
    hs_rs = g2 * hs_seg                            # a hidden-layer row
    wn_bytes = a16(units * odd_vectors(a, vec) * elem)
    wo_bytes = a * g2 * odd_vectors(cdiv(units, g2), vec) * elem
    stage = a16(rows * units * elem) + a16(rows * a * 4 if mode == 0 else 0)
    used, flags = 0, 0

    def place(flag, nbytes):
        nonlocal used, flags
        if used + a16(nbytes) > _MAX_SMEM_BYTES:
            return False
        used += a16(nbytes)
        flags |= flag
        return True

    place(1, 16 + 2 * clusters * rows * a * 4)
    place(2, 2 * rows * xs_rs * 4)
    place(4, rows * hs_rs * 4)
    place(8, (units + a) * 4)
    if stage <= _MAX_SMEM_BYTES:
        place(16, 32 + _WIDE_STAGES * stage)   # the stages' barriers first
    place(32, wn_bytes + wo_bytes)
    scratch = ((0 if flags & 1 else 2 * clusters * rows * a)
               + (0 if flags & 2 else 2 * rows * xs_rs)
               + (0 if flags & 4 else rows * hs_rs))
    blocks = clusters * grid_y
    expect = clusters * rows * a * 4 if flags & 1 and clusters > 1 else 0
    bulk = int(bool(flags & 16) and h * elem % 16 == 0
               and (mode != 0 or a * 4 % 16 == 0))
    return dict(clusters=clusters, units=units, rows=rows, groups=groups,
                grid_y=grid_y, g1=1 << lg1, g2=g2, flags=flags,
                smem_bytes=used, scratch_floats=blocks * scratch,
                blocks=blocks, expect_bytes=expect, threads=_WIDE_THREADS,
                bulk=bulk, xs_rs=xs_rs, hs_seg=hs_seg)


def wide_plan(lib, steps, batch, hidden, adim, elem, mode, sms) -> dict:
    """How the wide kernel cuts a launch (``ddpm_sampler_wide_plan``):
    blocks a cluster, hidden units and batch rows a block, row groups, the
    lanes sharing a sum in each product, the buffers in shared memory
    (bit flags: partial sums 1, sample 2, hidden layer 4, biases 8, ring
    16, weights 32), its bytes, the scratch floats it needs, the bytes a
    barrier phase of the exchange awaits, the threads of a block,
    whether one thread copies the ring's stages in bulk, and the floats of
    a sample row and of a lane's segment of the hidden layer;
    :func:`wide_sampler_plan` mirrors it."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    rc = lib.ddpm_sampler_wide_plan(steps, batch, hidden, adim, elem, mode,
                                    sms, out)
    if rc != 0:
        raise ValueError(
            f"ddpm_sampler: the wide kernel refused T={steps}, B={batch}, "
            f"H={hidden}, A={adim}: "
            f"{lib.ddpm_sampler_wide_error_string(rc).decode()}")
    return dict(zip(_PLAN_KEYS, out))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_facts(device):
    """(the current stream's handle, the SM count) of a CUDA device."""
    return (torch.cuda.current_stream(device).cuda_stream,
            _sm_count(device.index if device.index is not None
                      else torch.cuda.current_device()))


def _library(name):
    """The kernel library ``name`` with its C signatures declared."""
    lib = _build.load_library(name)
    if getattr(lib, "_signatures_set", False):
        return lib
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "ddpm_sampler":
        lib.ddpm_sampler_launch.argtypes = [vp] * 9 + [ci] * 4 + [
            ctypes.c_float, ci, ci, vp]
        lib.ddpm_sampler_launch.restype = ci
        lib.ddpm_sampler_smem_bytes.argtypes = [ci] * 4
        lib.ddpm_sampler_smem_bytes.restype = ctypes.c_size_t
        lib.ddpm_sampler_max_hidden.argtypes = [ci]
        lib.ddpm_sampler_max_hidden.restype = ci
    else:
        lib.ddpm_sampler_wide_launch.argtypes = [vp] * 10 + [ci] * 4 + [
            ctypes.c_float, ci, ci, ci, vp]
        lib.ddpm_sampler_wide_launch.restype = ci
        lib.ddpm_sampler_wide_plan.argtypes = [ci] * 7 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ddpm_sampler_wide_plan.restype = ci
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    lib._signatures_set = True
    return lib


def ddpm_sampler(noisy, contexts, noise: Optional[torch.Tensor], coeffs, wn,
                 bn, wo, bo, *, clip_value: float, ddim_x0clip: bool = False,
                 ddim_eps_recompute: bool = False,
                 _variant: Optional[str] = None) -> torch.Tensor:
    """The whole reverse loop; arguments as for
    :func:`ddpm_sample_reference`.  CPU tensors take the plain version; on
    a CUDA device this launches the kernel :func:`sampler_variant` names
    or raises.  ``_variant`` ('register' or 'wide') forces one kernel, so
    that the two can be held against each other at a shape both take."""
    mode = _mode(ddim_x0clip, ddim_eps_recompute)
    if mode == 0 and noise is None:
        raise ValueError("DDPM sampling needs per-step noise")
    if _variant is not None and _variant not in VARIANTS:
        raise ValueError(f"unknown sampler variant {_variant!r}")
    if contexts.device.type == "cpu":
        return ddpm_sample_reference(
            noisy, contexts, noise, coeffs, wn, bn, wo, bo,
            clip_value=clip_value, ddim_x0clip=ddim_x0clip,
            ddim_eps_recompute=ddim_eps_recompute)
    return _launch(noisy, contexts, noise, coeffs, wn, bn, wo, bo,
                   clip_value, mode, _variant)


class LaunchCount:
    """The launches of one kernel variant (``.launches``)."""

    def __init__(self):
        self.launches = 0


ddpm_sampler.launches = 0
ddpm_sampler.by_variant = {v: LaunchCount() for v in VARIANTS}


@torch.library.custom_op("tokenmerge::ddpm_sampler", mutates_args=())
def ddpm_sampler_op(noisy: torch.Tensor, contexts: torch.Tensor,
                    noise: Optional[torch.Tensor], coeffs: torch.Tensor,
                    wn: torch.Tensor, bn: torch.Tensor, wo: torch.Tensor,
                    bo: torch.Tensor, clip_value: float, ddim_x0clip: bool,
                    ddim_eps_recompute: bool) -> torch.Tensor:
    """:func:`ddpm_sampler` as the custom op ``tokenmerge::ddpm_sampler``,
    the name an exported program (``serve.export``) holds; the model's
    head calls it."""
    return ddpm_sampler(noisy, contexts, noise, coeffs, wn, bn, wo, bo,
                        clip_value=clip_value, ddim_x0clip=ddim_x0clip,
                        ddim_eps_recompute=ddim_eps_recompute)


@ddpm_sampler_op.register_fake
def _(noisy, contexts, noise, coeffs, wn, bn, wo, bo, clip_value,
      ddim_x0clip, ddim_eps_recompute):
    return noisy.new_empty(noisy.shape, dtype=torch.float32)
