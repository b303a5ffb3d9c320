"""Dropless routed experts: routing on the device, the grouped expert
products as hand-written CUDA kernels (``csrc/grouped_experts.cu``), and
their plain PyTorch version.

No TPU kernel stands behind this: the JAX package's only expert layer is
the GShard block (``modules/moe.py``: one-hot dispatch and combine einsums
over a capacity), which drops tokens and, at 64 experts, spends most of its
work on the one-hot tensors.  A DeepSeek-V3-style layer computes every one
of a token's ``k`` choices, so its work is ragged: each expert sees the
tokens routed to it, whatever their number.

:func:`sort_pairs` lays the (token, choice) pairs out by expert with device
operations alone (a stable sort, a count, a cumulative sum), so nothing is
read back to the host and a CUDA graph can hold the layer.  From those
offsets :func:`tile_plan` makes, also on the device, the schedule of row
tiles: tile ``i`` belongs to expert ``tile_expert[i]`` and starts at sorted
row ``tile_row[i]``; the grid is sized for the most tiles any routing can
need (``ceil(pairs / BLOCK_M) + experts``), and a block whose tile is past
the last exits at once.

The kernels (:func:`grouped_experts` on an sm_90 card; the source's note
says what bounds them and how they are built):

* ``expert_gate_up_kernel``: for a tile of one expert's rows, gathers the
  tokens' rows of x (bf16) and multiplies them by the expert's gate and up
  rows (``w_gate_up`` (E, 2F, H): gate rows first), accumulating both in
  float32, and writes the SwiGLU ``silu(gate) * up`` rounded to bf16;
* ``expert_down_kernel``: multiplies those rows by the expert's
  ``w_down`` (E, H, F) in float32, scales each row by its routing weight,
  and writes the row rounded to bf16, in sorted order;
* ``expert_combine_kernel``: each token's output is its shared-expert row
  plus its ``k`` rows, summed in float32 in the order of its choices and
  rounded once; no atomics, so a replay equals its eager twin bit for bit.

:func:`grouped_experts_reference` is the plain version: the same sorted
layout and groups, each group's products as float32 PyTorch products, the
same rounding points.  ``grouped_experts.launches`` counts the kernel
calls (three launches each).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from ..core.hw import on_cuda

__all__ = ["route", "sort_pairs", "tile_plan", "grouped_experts",
           "grouped_experts_reference", "PairLayout", "BLOCK_M"]

# rows of a tile: the tokens an expert sees come in tiles of this many
# (csrc/grouped_experts.cu: kBM)
BLOCK_M = 128
# the kernels take H a multiple of _H_STEP (the down kernel's output columns
# a block) and F of _F_STEP (the gate|up kernel's features a block)
_H_STEP = 128
_F_STEP = 64


def route(scores: torch.Tensor, bias: torch.Tensor, k: int, scale: float):
    """(T, E) float32 sigmoid scores and the (E,) selection bias -> the
    (T, k) float32 weights and int64 experts of each token.  The ``k``
    experts of highest ``score + bias`` are chosen (the lower index first
    among equals: a stable sort, as ``torch.topk`` on the card promises no
    order); the bias chooses and weighs nothing.  The chosen scores are
    normalised to sum to one, then scaled by ``scale``."""
    order = torch.sort(scores + bias.float(), dim=-1, descending=True,
                       stable=True).indices
    experts = order[:, :k]
    weights = torch.gather(scores, 1, experts)
    return weights / weights.sum(dim=-1, keepdim=True) * scale, experts


class PairLayout(NamedTuple):
    """The (token, choice) pairs laid out by expert.

    ``order`` (N,): the pair (``token * k + choice``) at each sorted row;
    ``tokens`` (N,) int32: its token; ``inverse`` (N,) int32: the sorted
    row of each pair; ``offsets`` (E + 1,) int32: expert e's rows are
    ``[offsets[e], offsets[e + 1])``.  All on the pairs' device."""

    order: torch.Tensor
    tokens: torch.Tensor
    inverse: torch.Tensor
    offsets: torch.Tensor


def sort_pairs(experts: torch.Tensor, num_experts: int) -> PairLayout:
    """The layout of the (T, k) chosen experts, by device operations alone:
    pairs sorted by expert (stable, so by token within an expert)."""
    flat = experts.reshape(-1)
    n = flat.numel()
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(num_experts, dtype=torch.int32,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones(n, dtype=torch.int32, device=flat.device))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    rows = torch.arange(n, dtype=torch.int32, device=flat.device)
    inverse = torch.empty_like(rows).scatter_(0, order, rows)
    tokens = (order // experts.shape[-1]).to(torch.int32)
    return PairLayout(order, tokens, inverse, offsets)


def tile_plan(offsets: torch.Tensor, pairs: int, block_m: int = BLOCK_M):
    """(tile_expert, tile_row) int32, each of ``ceil(pairs / block_m) +
    experts`` entries, the most tiles any routing needs: the expert and the
    first sorted row of each tile, expert ``E`` past the last tile."""
    e = offsets.numel() - 1
    counts = offsets[1:] - offsets[:-1]
    tiles = (counts + block_m - 1) // block_m
    ends = torch.cumsum(tiles, 0, dtype=torch.int32)
    grid = -(-pairs // block_m) + e
    idx = torch.arange(grid, dtype=torch.int32, device=offsets.device)
    expert = torch.searchsorted(ends, idx, right=True).to(torch.int32)
    held = expert.clamp_max(e - 1).long()
    first = ends[held] - tiles[held]
    row = offsets[held] + (idx - first) * block_m
    return expert, row.to(torch.int32)


def grouped_experts_reference(x: torch.Tensor, w_gate_up: torch.Tensor,
                              w_down: torch.Tensor, weights: torch.Tensor,
                              experts: torch.Tensor,
                              shared: torch.Tensor) -> torch.Tensor:
    """(T, H) x, (E, 2F, H) gate|up, (E, H, F) down, (T, k) float32 routing
    weights and int64 experts, (T, H) shared-expert output -> (T, H) in
    x's dtype: ``shared + sum_i w_i * down_e(silu(gate_e x) * up_e x)``,
    as the kernels compute it.  Each expert's group of the sorted pairs
    through float32 products; the SwiGLU and each weighted row rounded to
    x's dtype; the sum in float32 in the order of the choices."""
    t, k = experts.shape
    f = w_down.shape[-1]
    layout = sort_pairs(experts, w_gate_up.shape[0])
    ends = layout.offsets.tolist()
    w = weights.reshape(-1)[layout.order]
    rows = []
    for e in range(w_gate_up.shape[0]):
        lo, hi = ends[e], ends[e + 1]
        if lo == hi:
            continue
        a = x[layout.tokens[lo:hi].long()].float()
        gu = F.linear(a, w_gate_up[e].float())
        h = (F.silu(gu[:, :f]) * gu[:, f:]).to(x.dtype)
        y = F.linear(h.float(), w_down[e].float()) * w[lo:hi, None]
        rows.append(y.to(x.dtype))
    y = torch.cat(rows)[layout.inverse.long()].reshape(t, k, -1)
    acc = shared.float()
    for i in range(k):
        acc = acc + y[:, i].float()
    return acc.to(x.dtype)


def _library():
    lib = _build.load_library("grouped_experts")
    if not getattr(lib, "_signatures_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ge_prepare.argtypes = []
        lib.ge_prepare.restype = ci
        lib.ge_launch.argtypes = [vp] * 13 + [ci] * 6 + [vp]
        lib.ge_launch.restype = ci
        lib.ge_error_string.argtypes = [ci]
        lib.ge_error_string.restype = ctypes.c_char_p
        rc = lib.ge_prepare()
        if rc != 0:
            raise RuntimeError("grouped_experts: cannot give the kernels "
                               "their shared memory: "
                               f"{lib.ge_error_string(rc).decode()}")
        lib._signatures_set = True
    return lib


def _check(x, w_gate_up, w_down, weights, experts, shared):
    t, h = x.shape
    e, f2, h2 = w_gate_up.shape
    if (h2 != h or f2 % 2 or tuple(w_down.shape) != (e, h, f2 // 2)
            or weights.shape != experts.shape or experts.shape[0] != t
            or tuple(shared.shape) != (t, h)):
        raise ValueError(
            f"grouped_experts: x {tuple(x.shape)}, w_gate_up "
            f"{tuple(w_gate_up.shape)}, w_down {tuple(w_down.shape)}, "
            f"weights {tuple(weights.shape)}, experts "
            f"{tuple(experts.shape)}, shared {tuple(shared.shape)} do not "
            f"agree")


def grouped_experts(x: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, weights: torch.Tensor,
                    experts: torch.Tensor,
                    shared: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_experts_reference`'s function: its plain version for
    CPU tensors; on a CUDA device the kernels (bf16 operands, H a
    multiple of 128 and F of 64) or a raise."""
    _check(x, w_gate_up, w_down, weights, experts, shared)
    if x.device.type == "cpu":
        return grouped_experts_reference(x, w_gate_up, w_down, weights,
                                         experts, shared)
    if not on_cuda(x, w_gate_up, w_down, shared):
        raise RuntimeError("grouped_experts: the kernels need every operand "
                           "on one sm_90 CUDA device")
    t, h = x.shape
    e, f2, _ = w_gate_up.shape
    f = f2 // 2
    if (x.dtype != torch.bfloat16 or w_gate_up.dtype != torch.bfloat16
            or w_down.dtype != torch.bfloat16
            or shared.dtype != torch.bfloat16 or h % _H_STEP
            or f % _F_STEP):
        raise ValueError(
            f"grouped_experts: the kernels take bf16 operands with H a "
            f"multiple of {_H_STEP} and F of {_F_STEP}; got {x.dtype}, "
            f"{w_gate_up.dtype}, {w_down.dtype}, {shared.dtype}, H={h}, "
            f"F={f}")
    x, shared = x.contiguous(), shared.contiguous()
    w_gate_up, w_down = w_gate_up.contiguous(), w_down.contiguous()
    if any(a.data_ptr() % 16 for a in (x, shared, w_gate_up, w_down)):
        raise ValueError("grouped_experts: the kernels take operands that "
                         "start on a 16-byte boundary")
    k = experts.shape[1]
    n = t * k
    layout = sort_pairs(experts, e)
    tile_expert, tile_row = tile_plan(layout.offsets, n)
    w = weights.reshape(-1)[layout.order].float().contiguous()
    hid = torch.empty((n, f), dtype=x.dtype, device=x.device)
    y = torch.empty((n, h), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    lib = _library()
    rc = lib.ge_launch(
        x.data_ptr(), w_gate_up.data_ptr(), w_down.data_ptr(),
        shared.data_ptr(), hid.data_ptr(), y.data_ptr(), out.data_ptr(),
        layout.tokens.data_ptr(), layout.inverse.data_ptr(), w.data_ptr(),
        layout.offsets.data_ptr(), tile_expert.data_ptr(),
        tile_row.data_ptr(), t, k, e, h, f, tile_expert.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("grouped_experts kernel launch failed: "
                           f"{lib.ge_error_string(rc).decode()}")
    grouped_experts.launches += 1
    return out


grouped_experts.launches = 0
