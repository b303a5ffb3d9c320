"""Fused DDPM / DDIM reverse sampler: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of the JAX package's ``ops/ddpm_sampler.py:fused_ddpm_sample``
(Pallas kernel ``_sampler_kernel``).  The kernel, ``csrc/ddpm_sampler.cu``,
runs the whole T-step reverse loop of a ``num_blocks == 1`` denoiser in one
launch, the weights in registers and the per-step contexts, coefficients
and noise in shared memory; its source note says what bounds it and how the
design answers.

:func:`ddpm_sampler` runs :func:`ddpm_sample_reference` for CPU tensors,
launches the kernel for tensors on an sm_90 card, and raises for anything
else.  ``ddpm_sampler.launches`` counts kernel launches.
:func:`ddpm_sampler_op` is the same function registered as the custom op
``tokenmerge::ddpm_sampler`` (with a shape function for tracing), so that
``torch.export`` can carry it.

Weights come in ``torch.nn.Linear`` layout: ``wn`` (H, A) and ``wo``
(A, H), so ``h = x @ wn.T`` and ``eps = h @ wo.T``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..core.hw import on_cuda

__all__ = ["ddpm_sampler", "ddpm_sampler_op", "ddpm_sample_reference",
           "MAX_ACTION_DIM"]

MAX_ACTION_DIM = 16          # kMaxA in the kernel
_MAX_SMEM_BYTES = 232448     # a block's shared memory on sm_90
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
            mode) -> torch.Tensor:
    steps, batch, hidden = contexts.shape
    adim = noisy.shape[-1]
    cd = contexts.dtype
    if cd not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute dtype {cd}")
    if not 1 <= adim <= MAX_ACTION_DIM:
        raise ValueError(f"action dim {adim} outside [1, {MAX_ACTION_DIM}]")
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

    lib = _library()
    widest = lib.ddpm_sampler_max_hidden(adim)
    if hidden > widest:
        raise ValueError(
            f"ddpm_sampler: hidden width {hidden} above the {widest} units "
            f"the kernel holds in registers at action dim {adim}")
    elem = contexts.element_size()
    smem = lib.ddpm_sampler_smem_bytes(steps, hidden, adim, elem)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"ddpm_sampler: T={steps}, H={hidden} needs {smem} bytes of "
            f"shared memory per block, more than {_MAX_SMEM_BYTES}")
    out = torch.empty_like(noisy)
    stream = torch.cuda.current_stream(noisy.device).cuda_stream
    rc = lib.ddpm_sampler_launch(
        noisy.data_ptr(), contexts.data_ptr(),
        noise.data_ptr() if mode == 0 else None, coeffs.data_ptr(),
        wn.data_ptr(), bn.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out.data_ptr(), steps, batch, hidden, adim, float(clip_value),
        _DTYPE_CODES[cd], mode, stream)
    if rc != 0:
        msg = lib.ddpm_sampler_error_string(rc).decode()
        raise RuntimeError(f"ddpm_sampler kernel launch failed: {msg}")
    ddpm_sampler.launches += 1
    return out


def _library():
    """The kernel library with its C signatures declared."""
    lib = _build.load_library("ddpm_sampler")
    if not getattr(lib, "_signatures_set", False):
        vp = ctypes.c_void_p
        lib.ddpm_sampler_launch.argtypes = [vp] * 9 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 vp]
        lib.ddpm_sampler_launch.restype = ctypes.c_int
        lib.ddpm_sampler_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.ddpm_sampler_smem_bytes.restype = ctypes.c_size_t
        lib.ddpm_sampler_max_hidden.argtypes = [ctypes.c_int]
        lib.ddpm_sampler_max_hidden.restype = ctypes.c_int
        lib.ddpm_sampler_error_string.argtypes = [ctypes.c_int]
        lib.ddpm_sampler_error_string.restype = ctypes.c_char_p
        lib._signatures_set = True
    return lib


def ddpm_sampler(noisy, contexts, noise: Optional[torch.Tensor], coeffs, wn,
                 bn, wo, bo, *, clip_value: float, ddim_x0clip: bool = False,
                 ddim_eps_recompute: bool = False) -> torch.Tensor:
    """The whole reverse loop; arguments as for
    :func:`ddpm_sample_reference`.  CPU tensors take the plain version; on
    a CUDA device this launches the kernel or raises."""
    mode = _mode(ddim_x0clip, ddim_eps_recompute)
    if mode == 0 and noise is None:
        raise ValueError("DDPM sampling needs per-step noise")
    if contexts.device.type == "cpu":
        return ddpm_sample_reference(
            noisy, contexts, noise, coeffs, wn, bn, wo, bo,
            clip_value=clip_value, ddim_x0clip=ddim_x0clip,
            ddim_eps_recompute=ddim_eps_recompute)
    return _launch(noisy, contexts, noise, coeffs, wn, bn, wo, bo,
                   clip_value, mode)


ddpm_sampler.launches = 0


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
