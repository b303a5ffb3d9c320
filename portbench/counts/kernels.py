"""Least bytes, operations and time of single kernels on one H100 SXM.

Frozen copies of ``chip_smoke.py``'s ``bound`` (there in milliseconds,
here in seconds), ``flash_bytes_flops`` and ``sampler_bound_ms``, with
dtypes named by string.  Each input byte is counted read once and each
output byte written once; operations are 2 per multiply-add.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "ELEMENT_BYTES", "bound",
           "flash_bytes_flops", "sampler_bytes_flops"]

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """The least seconds of moving ``nbytes`` and doing ``flops`` of
    ``dtype`` on the card, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def flash_bytes_flops(b, s, h, d, nnz, dtype: str, kind: str):
    """Least bytes and matmul FLOPs of one flash pass over (b, s, h, d)
    tensors whose mask lets ``nnz`` (query, key) pairs attend per row and
    head.  ``kind``: 'fwd_plain' (no log-sum-exp saved), 'fwd', 'dq',
    'dkv'."""
    e = ELEMENT_BYTES[dtype]
    act = b * s * h * d * e
    stats = b * h * s * 4
    tensors, nstats, products = {"fwd_plain": (4, 0, 2), "fwd": (4, 1, 2),
                                 "dq": (5, 2, 3), "dkv": (6, 2, 4)}[kind]
    nbytes = tensors * act + nstats * stats + s * s
    return nbytes, 2 * products * b * h * d * nnz


def sampler_bytes_flops(batch, steps, hidden, adim, dtype: str,
                        mode: str = "ddpm"):
    """Least bytes and FLOPs of one fused reverse loop: the initial sample,
    every step's contexts (and noise for DDPM), the coefficients, both
    weight matrices and biases in, the actions out; two products a step."""
    e = ELEMENT_BYTES[dtype]
    ncoef = 3 if mode == "ddpm" else 4
    nbytes = (batch * adim * 4 + steps * batch * hidden * e
              + (steps * batch * adim * 4 if mode == "ddpm" else 0)
              + steps * ncoef * 4 + 2 * hidden * adim * e + (hidden + adim) * e
              + batch * adim * 4)
    return nbytes, steps * batch * 4 * hidden * adim
