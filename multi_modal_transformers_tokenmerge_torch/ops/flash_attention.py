"""Block-sparse masked flash attention: the plain forward, the LSE-saving
forward and the dq / dk-dv backward, as the CUDA kernels' wrappers, their
plain PyTorch versions and the autograd functions that join them.

Counterpart of the JAX package's ``ops/flash_attention.py`` (Pallas kernels
``_flash_kernel``, ``_flash_fwd_lse_kernel``, ``_flash_dq_kernel`` and
``_flash_dkv_kernel``, driven by ``_flash_attention_vjp`` and
``_flash_attention_vjp_native``).  The kernels live in
``csrc/flash_attention.cu``; its source note says what bounds them and how
the design answers.

* :func:`flash_fwd`, :func:`flash_fwd_lse`, :func:`flash_dq` and
  :func:`flash_dkv` run their plain versions (``*_reference``, written
  from the kernel bodies: the same tiles, online softmax and rounding
  points) for CPU tensors, launch the kernel for tensors on an sm_90 card,
  and raise for anything else.  Each counts its kernel launches in
  ``.launches``.  The kernels of ``csrc/flash_attention.cu`` are compiled
  for head dims 32, 64, 128 and 256 (``KERNEL_TILES``); on the card every
  other head dim up to 256 runs at the next compiled one
  (:func:`at_compiled_dim`: operands zero-padded along D, the true
  1/sqrt(D) as the scale, outputs cut back).  Above 256 each wrapper hands
  the call to its wide counterpart (:func:`flash_fwd_wide`,
  :func:`flash_fwd_lse_wide`, :func:`flash_dq_wide`, :func:`flash_dkv_wide`,
  counted apart), the kernels of ``csrc/flash_attention_wide.cu``, which
  take any multiple of 64 (``WIDE_TILES``; other head dims zero-padded to
  the next one) and cut D into reduction chunks and output slices; their
  plain versions (``flash_*_wide_reference``) compute the same way.  The
  forwards run on the tensor cores in bf16 and fp16 and on the CUDA cores
  in float32.  ``out_dtype=torch.float32``
  makes :func:`flash_fwd_lse`, :func:`flash_dq` and :func:`flash_dkv` (and
  :func:`flash_bwd`, the pair) write their outputs in float32 for 16-bit
  inputs, unrounded: the ring-attention steps' partials.
  :func:`flash_fwd_op` is :func:`flash_fwd` registered as the custom op
  ``tokenmerge::flash_fwd`` (with a shape function), which ``torch.export``
  can carry.
* The mask and the skip tables are device tensors (``mask_i8`` padded to the
  tiles, ``k_hi`` per q tile, ``q_lo`` per k tile), cached per (mask digest,
  tiles, device), so the ring-attention path can later pass its own.  On a
  CUDA device :func:`flash_attention` and the hook of
  :func:`make_attention_fn` build them at the card's tiles
  (:func:`run_tiles`) whatever tiles they are handed: those are the TPU
  kernels' (``flash_block_q/k``), and the function does not depend on them
  (the dropout counter is per element).
* Dropout of the attention weights is rebuilt, not copied: the TPU kernel
  re-seeds its hardware PRNG per tile, a stream nothing else reproduces.
  Here the keep bit of element (b, h, row, col) is word ``col & 3`` of
  Philox4x32-10 at counter ``(col >> 2, row, (b0 + b)*H_total + h0 + h,
  0)`` under the key of two 32-bit seed words; an element is kept when
  that word is at least :func:`dropout_threshold`.  ``b0`` is the call's
  first row in the global batch: 0 on one device, and inside a
  data-parallel step (``core.global_batch.data_parallel``) the rank's
  offset, which :func:`flash_attention` and the hook of
  :func:`make_attention_fn` take from ``core.global_batch.row_offset``.
  ``h0`` and ``H_total`` place the call's H heads among all heads: (0, H)
  on one device, and for a rank of a tensor-parallel attention, which
  holds heads ``[h0, h0 + H)``, ``core.tensor_parallel.head_offset``.  So
  P ranks, over rows or heads, draw the mask of the one-device step.  Forward, dq and dk/dv regenerate the same mask
  whatever their tile sizes, and :func:`dropout_keep_mask` computes the
  same bits in torch integer arithmetic.
* :func:`flash_attention` is the differentiable entry on the JAX layout
  (B, S, H, D).  ``backward='pallas'`` saves the LSE and runs the dq and
  dk/dv kernels; ``backward='xla'`` runs :func:`flash_fwd`, which writes no
  LSE and draws no dropout bits (the forward a server wants), and
  differentiates by recomputing :func:`xla_reference_attention` on the
  saved q, k, v.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..core.global_batch import row_offset
from ..core.hw import on_cuda
from ..core.tensor_parallel import head_offset

__all__ = ["flash_attention", "make_attention_fn", "flash_fwd", "flash_fwd_op",
           "flash_fwd_lse", "flash_dq", "flash_dkv", "flash_bwd",
           "flash_fwd_reference",
           "flash_fwd_lse_reference",
           "flash_dq_reference", "flash_dkv_reference", "attention_delta",
           "xla_reference_attention", "tile_skip_tables", "mask_tables",
           "device_tables", "dropout_threshold", "dropout_keep_mask",
           "KERNEL_TILES", "WIDE_TILES", "WIDE_CHUNK", "WIDE_CHUNKS",
           "WIDE_SLICES", "WIDE_CLUSTER_MAX",
           "wide_forward_plan", "wide_backward_plan",
           "compiled_head_dim", "is_wide", "kernel_tiles", "run_tiles",
           "at_compiled_dim", "flash_fwd_wide", "flash_fwd_lse_wide",
           "flash_dq_wide", "flash_dkv_wide", "flash_fwd_wide_reference",
           "flash_fwd_lse_wide_reference", "flash_dq_wide_reference",
           "flash_dkv_wide_reference"]

NEG_INF = -1e30
# head_dim -> (block_q, block_k) compiled into csrc/flash_attention.cu
# (Traits<D>); other head dims up to the largest run padded to the next one
KERNEL_TILES = {32: (64, 64), 64: (64, 64), 128: (64, 64), 256: (32, 32)}
# csrc/flash_attention_wide.cu, every head dim above the largest of
# KERNEL_TILES: its tiles, the multiple of 64 a head dim is padded to, and
# by kernel the columns of a reduction chunk over D and the output columns
# of a slice a block owns (16-bit; the float32 kernels cut chunks and
# slices of 64).  The forwards' chunk is their cluster body's, whose logits
# are the slices' partials summed in order; above WIDE_CLUSTER_MAX slices
# they run their chunked body (wide_forward_plan).  dq's and dk/dv's are
# their chunked bodies' (above WIDE_CLUSTER_MAX slices); up to it they run
# the cluster body, whose sums are the slices' partials like the forwards'
# (wide_backward_plan)
WIDE_TILES = (64, 64)
WIDE_CHUNK = 64
WIDE_CHUNKS = {"fwd": 128, "dq": 32, "dkv": 64}
WIDE_SLICES = {"fwd": 128, "dq": 128, "dkv": 128}
WIDE_CLUSTER_MAX = 8    # blocks of a cluster: the portable most
WIDE_MAX_SMEM = 232448  # dynamic shared bytes a block may have (227 KB)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# -- tables -------------------------------------------------------------------

def tile_skip_tables(mask: np.ndarray, block_q: int, block_k: int):
    """(k_hi, q_lo) int32 skip tables of one tile-aligned mask: per q tile
    the number of key tiles it attends into, per k tile the lowest q tile
    that attends into it (``num_q`` when none does)."""
    s_q, s_k = mask.shape
    if s_q % block_q or s_k % block_k:
        raise ValueError(f"mask tile {mask.shape} not divisible by blocks "
                         f"({block_q}, {block_k})")
    num_q, num_k = s_q // block_q, s_k // block_k
    m = mask.astype(bool)
    k_hi = np.zeros((num_q,), np.int32)
    for qi in range(num_q):
        cols = np.nonzero(m[qi * block_q:(qi + 1) * block_q].any(axis=0))[0]
        k_hi[qi] = 0 if cols.size == 0 else (cols.max() // block_k) + 1
    q_lo = np.zeros((num_k,), np.int32)
    for ki in range(num_k):
        rows = np.nonzero(m[:, ki * block_k:(ki + 1) * block_k].any(axis=1))[0]
        q_lo[ki] = num_q if rows.size == 0 else rows.min() // block_q
    return k_hi, q_lo


def mask_tables(mask: np.ndarray, block_q: int, block_k: int):
    """(padded int8 mask, k_hi, q_lo) of an (S, S) bool mask, padded with
    zeros to a multiple of lcm(block_q, block_k)."""
    s = mask.shape[0]
    lcm = math.lcm(block_q, block_k)
    s_pad = lcm * -(-s // lcm)
    padded = np.zeros((s_pad, s_pad), dtype=np.int8)
    padded[:s, :s] = mask.astype(np.int8)
    k_hi, q_lo = tile_skip_tables(padded, block_q, block_k)
    return padded, k_hi, q_lo


def _mask_digest(mask: np.ndarray) -> str:
    return hashlib.sha1(mask.tobytes()
                        + repr((mask.shape, mask.dtype.str)).encode()
                        ).hexdigest()[:20]


_TABLE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_TABLE_CACHE_MAX = 256


def _resolve_device(device) -> torch.device:
    """``device`` with a CUDA device's index filled in (the current one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _build_tables(mask: np.ndarray, block_q: int, block_k: int, device):
    """:func:`mask_tables` as tensors on ``device`` (int8 mask, int32
    tables).  The tensors are made outside inference mode, so that tables
    first built while serving can later be saved for a backward pass."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in mask_tables(mask, block_q, block_k))


def device_tables(mask: np.ndarray, block_q: int, block_k: int, device):
    """:func:`mask_tables` as tensors on ``device``, cached per (mask
    digest, tiles, device), LRU-bounded: for callers that hand
    :func:`flash_attention` a mask at every call.  A hook of
    :func:`make_attention_fn` keeps its own tables instead and hashes no
    mask.  A CUDA device without an index means the current one."""
    device = _resolve_device(device)
    key = (_mask_digest(mask), block_q, block_k, str(device))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        _TABLE_CACHE.move_to_end(key)
        return hit
    tables = _build_tables(mask, block_q, block_k, device)
    _TABLE_CACHE[key] = tables
    while len(_TABLE_CACHE) > _TABLE_CACHE_MAX:
        _TABLE_CACHE.popitem(last=False)
    return tables


def is_wide(head_dim: int) -> bool:
    """Whether ``head_dim`` runs on the wide kernels (above 256)."""
    return head_dim > max(KERNEL_TILES)


def compiled_head_dim(head_dim: int) -> int:
    """The head dim the kernels run ``head_dim`` at: itself, or the next
    one up to which the operands are zero-padded: up to 256 the next of
    ``KERNEL_TILES``, above it the next multiple of ``WIDE_CHUNK``."""
    if head_dim <= 0:
        raise ValueError(f"head dim {head_dim}: the kernels take any head "
                         f"dim from 1")
    if is_wide(head_dim):
        return WIDE_CHUNK * -(-head_dim // WIDE_CHUNK)
    return min(d for d in KERNEL_TILES if head_dim <= d)


def wide_forward_plan(head_dim: int) -> dict:
    """How the 16-bit wide forwards run ``head_dim`` (at
    :func:`compiled_head_dim`), as ``csrc/flash_attention_wide.cu:fwd_plan``
    launches them: ``body`` ("cluster": the slice blocks of a query tile
    one thread block cluster, exchanging partial logits; "chunked": each
    slice block computing all of them), ``cluster`` (blocks of a cluster,
    1 for the chunked body), ``slice`` and ``last_slice`` (output columns
    of a block and of the last one), ``smem`` (dynamic shared bytes of a
    block) and ``chunk`` (columns of the logits' partial sums, summed in
    order: the plain versions' cut)."""
    d = compiled_head_dim(head_dim)
    if not is_wide(d):
        raise ValueError(f"head dim {head_dim} runs on the narrow kernels")
    width = WIDE_SLICES["fwd"]
    nsl = -(-d // width)
    plan = dict(slice=width, last_slice=d - (nsl - 1) * width)
    if nsl <= WIDE_CLUSTER_MAX:
        # ClusterSmem: the K and V rings, the owned row groups' partials
        # from every block, every group's P, alpha and row sums, the row
        # maxima, the mask ring, six barriers and the swizzle's alignment
        owned = -(-4 // nsl)
        smem = (1024 + 4 * 64 * 128 * 2 + owned * nsl * 64 * 16 * 4
                + 4 * 4 * 32 * 16 + 2 * 4 * 32 * 8 + 2 * 4 * 16 * 4
                + 2 * 64 * 80 + 6 * 8)
        return dict(body="cluster", cluster=nsl, smem=smem,
                    chunk=WIDE_CHUNKS["fwd"], **plan)
    # FwdSmem: the Q and K chunk rings, the V slice and mask rings
    return dict(body="chunked", cluster=1,
                smem=2 * 2 * (128 * 72 + 64 * 136) + 2 * 64 * 80,
                chunk=WIDE_CHUNK, **plan)


def wide_backward_plan(kind: str, head_dim: int) -> dict:
    """How the 16-bit wide ``kind`` ("dq" or "dkv") runs ``head_dim`` (at
    :func:`compiled_head_dim`), as ``csrc/flash_attention_wide.cu:bwd_plan``
    launches it, in :func:`wide_forward_plan`'s keys: "cluster" (the slice
    blocks of a row tile one cluster, exchanging partial S and dP), or
    "chunked" (each slice block computing all of them), with ``chunk`` the
    columns of the partial sums of S and dP, summed in order, and
    ``buffers`` the cluster body's exchange buffers (2: the next tile's
    partials sent while this tile's fragments travel, where two fit)."""
    if kind not in ("dq", "dkv"):
        raise ValueError(f"kind {kind!r}: 'dq' or 'dkv'")
    d = compiled_head_dim(head_dim)
    if not is_wide(d):
        raise ValueError(f"head dim {head_dim} runs on the narrow kernels")
    width = WIDE_SLICES[kind]
    nsl = -(-d // width)
    plan = dict(slice=width, last_slice=d - (nsl - 1) * width)
    if nsl <= WIDE_CLUSTER_MAX:
        # BwdSmem: the two streamed rings; by buffer (two, pipelined, where
        # they fit a block) the owned row groups' partial S and dP from
        # every block and every group's fragments (dS; dk/dv P too); the q
        # tile's LSE and delta, the mask ring, eight barriers and the
        # swizzle's alignment
        owned, frags = -(-4 // nsl), 2 if kind == "dkv" else 1
        smem = lambda nb: (1024 + 4 * 64 * 128 * 2
                           + nb * (owned * nsl * 2 * 64 * 16 * 4
                                   + frags * 4 * 4 * 32 * 16)
                           + 2 * 2 * 64 * 4 + 2 * 64 * 80 + 8 * 8)
        buffers = 2 if smem(2) <= WIDE_MAX_SMEM else 1
        return dict(body="cluster", cluster=nsl, smem=smem(buffers),
                    chunk=width, buffers=buffers, **plan)
    # DqSmem: the Q, dO, K and V chunk rings, the K slice and mask rings;
    # DkvShape: the K, V, Q and dO chunk rings, the Q and dO slice rings,
    # P^T and dS^T, the LSE and delta rings, the mask ring
    smem = (2 * 2 * (256 * 40 + 64 * 136) + 2 * 64 * 80 if kind == "dq" else
            2 * 2 * (256 * 72 + 2 * 64 * 136 + 64 * 72) + 4 * 4 * 64
            + 2 * 64 * 80)
    return dict(body="chunked", cluster=1, smem=smem,
                chunk=WIDE_CHUNKS[kind], buffers=1, **plan)


def kernel_tiles(head_dim: int) -> Optional[Tuple[int, int]]:
    """The tiles the card's kernels take at ``head_dim`` (those of
    :func:`compiled_head_dim`; ``WIDE_TILES`` above 256), or None for a
    head dim below 1."""
    if head_dim <= 0:
        return None
    if is_wide(head_dim):
        return WIDE_TILES
    return KERNEL_TILES[compiled_head_dim(head_dim)]


def run_tiles(head_dim: int, device, block_q: Optional[int] = None,
              block_k: Optional[int] = None) -> Tuple[int, int]:
    """The tiles a call at ``head_dim`` on ``device`` runs at: on a CUDA
    device the card's (:func:`kernel_tiles`), whatever it is handed, since
    configured tiles are the TPU kernels' (``flash_block_q/k``) and the
    function does not depend on them; elsewhere ``block_q``/``block_k``
    where given (the plain versions take any tiles), else the card's."""
    tiles = kernel_tiles(head_dim)
    if torch.device(device).type == "cuda":
        return tiles
    return block_q or tiles[0], block_k or tiles[1]


def at_compiled_dim(fn, operands, *rest, **kw):
    """``fn(*operands, *rest, scale=1/sqrt(D), **kw)`` at the compiled head
    dim: the (B, S, H, D) ``operands`` zero-padded along D to
    :func:`compiled_head_dim` (fresh, contiguous, 16-byte aligned copies)
    and every (B, S, H, ·) output cut back to D; unpadded at a compiled D.
    A zero column adds nothing to a logit, so the softmax, the LSE and
    delta are those of D, and every output's extra columns are zero; the
    scale is the true D's.  The dropout counter does not involve D, so the
    masks are D's too."""
    d = operands[0].shape[-1]
    dp = compiled_head_dim(d)
    kw["scale"] = 1.0 / math.sqrt(d)
    if dp == d:
        return fn(*operands, *rest, **kw)
    out = fn(*(F.pad(x, (0, dp - d)) for x in operands), *rest, **kw)
    cut = lambda t: t[..., :d].contiguous() if t.dim() == 4 else t
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


# -- dropout bits ---------------------------------------------------------------

def dropout_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) = rate."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for m < 2**32 and int64 c < 2**32,
    without overflowing int64."""
    p_lo = (c & 0xFFFF) * m
    p_hi = (c >> 16) * m
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def _philox4x32(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_mask(seed: torch.Tensor, batch: int, heads: int,
                      rows: torch.Tensor, cols: torch.Tensor,
                      rate: float, b0: int = 0, h0: int = 0,
                      heads_total: Optional[int] = None) -> torch.Tensor:
    """(B, H, len(rows), len(cols)) bool keep mask of the global query
    ``rows`` and key ``cols`` of batch rows ``b0`` to ``b0 + B`` and heads
    ``h0`` to ``h0 + H`` of ``heads_total`` (default H): the kernels'
    Philox bits, on seed's device."""
    dev = seed.device
    k0, k1 = (seed.to(torch.int64) & _MASK32).unbind()
    total = heads if heads_total is None else heads_total
    arange = lambda n: torch.arange(n, device=dev, dtype=torch.int64)
    bh = ((b0 + arange(batch)).view(batch, 1, 1, 1) * total
          + h0 + arange(heads).view(1, heads, 1, 1))
    r = rows.to(device=dev, dtype=torch.int64).view(1, 1, -1, 1)
    c = cols.to(device=dev, dtype=torch.int64).view(1, 1, 1, -1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = _philox4x32(c >> 2, r, bh, zero, k0, k1)
    lane = c & 3
    bits = torch.where(lane == 0, words[0],
                       torch.where(lane == 1, words[1],
                                   torch.where(lane == 2, words[2],
                                               words[3])))
    return bits >= dropout_threshold(rate)


# -- plain versions ---------------------------------------------------------------

def _heads_first(x: torch.Tensor, s_pad: int) -> torch.Tensor:
    """(B, S, H, D) -> float32 (B, H, S_pad, D), zero-padded rows."""
    x = x.permute(0, 2, 1, 3).float()
    return F.pad(x, (0, 0, 0, s_pad - x.shape[2]))


def _rows(i: int, block: int, device) -> torch.Tensor:
    return torch.arange(i * block, (i + 1) * block, device=device)


def _logits(a, b, chunk=None):
    """a b^T of float32 (B, H, M, D) and (B, H, N, D): in one product, or,
    with ``chunk``, summed over D chunk by chunk in order (the wide
    kernels' accumulation)."""
    if chunk is None:
        return a @ b.transpose(-1, -2)
    s = None
    for c0 in range(0, a.shape[-1], chunk):
        part = a[..., c0:c0 + chunk] @ b[..., c0:c0 + chunk].transpose(-1, -2)
        s = part if s is None else s + part
    return s


def _slices(d: int, width: Optional[int]):
    """The output column slices a kernel's blocks own: one, or ``width``
    columns each (the last may be narrower)."""
    if width is None:
        return [slice(None)]
    return [slice(c0, min(c0 + width, d)) for c0 in range(0, d, width)]


def _forward_tiles(q, k, v, mask_i8, k_hi, seed, block_q, block_k,
                   dropout_rate, b0=0, h0=0, heads_total=None, scale=None,
                   chunk=None, slice_width=None):
    """The forward kernels' loop: float32 (out (B, H, S_pad, D), running
    max m, running sum l clamped at 1e-30 (B, H, S_pad, 1)).  ``chunk`` and
    ``slice_width`` cut D as the wide kernels do: the logits summed over
    the chunks in order, the output accumulated slice by slice (each of
    the kernels' slice blocks recomputes the same logits, bitwise equal, so
    they are computed once here)."""
    b, s, h, d = q.shape
    s_pad = mask_i8.shape[0]
    scale = scale or 1.0 / math.sqrt(d)
    qf, kf, vf = (_heads_first(x, s_pad) for x in (q, k, v))
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    out = torch.zeros(b, h, s_pad, d, device=q.device)
    m_all = torch.empty(b, h, s_pad, 1, device=q.device)
    l_all = torch.empty(b, h, s_pad, 1, device=q.device)
    slices = _slices(d, slice_width)
    for qi, hi in enumerate(k_hi.tolist()):
        rq = slice(qi * block_q, (qi + 1) * block_q)
        m = torch.full((b, h, block_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for ki in range(hi):
            rk = slice(ki * block_k, (ki + 1) * block_k)
            sc = _logits(qf[:, :, rq], kf[:, :, rk], chunk) * scale
            sc = torch.where(mask_i8[rq, rk] != 0, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - torch.clamp_min(m_new, 0.5 * NEG_INF))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if dropout_rate > 0:
                keep = dropout_keep_mask(seed, b, h,
                                         _rows(qi, block_q, q.device),
                                         _rows(ki, block_k, q.device),
                                         dropout_rate, b0, h0, heads_total)
                p = torch.where(keep, p, 0.0) * inv_keep
            pv = p.to(v.dtype).float()
            for cols in slices:
                acc[..., cols] = acc[..., cols] * alpha + pv @ vf[:, :, rk,
                                                                  cols]
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[:, :, rq] = acc / l_safe
        m_all[:, :, rq] = m
        l_all[:, :, rq] = l_safe
    return out, m_all, l_all


def flash_fwd_reference(q, k, v, mask_i8, k_hi, *, block_q: int,
                        block_k: int, scale: Optional[float] = None,
                        chunk: Optional[int] = None,
                        slice_width: Optional[int] = None):
    """Plain version of the forward kernel without LSE or dropout (the JAX
    package's ``_flash_kernel``).

    q, k, v (B, S, H, D); ``mask_i8`` (S_pad, S_pad) int8, tile-aligned;
    ``k_hi`` (S_pad/block_q,) int.  Logits are float32 products of
    input-dtype operands times ``scale`` (default 1/sqrt(D); a padded call
    passes the true D's), masked to -1e30; online max and
    sum in float32 over the key tiles below ``k_hi``, the reference of the
    exponent clamped at -5e29 so a row with no live key keeps p = 0; p cast
    to v's dtype before P V; ``acc / max(l, 1e-30)`` in q's dtype, zeros for
    dead rows.  ``chunk`` and ``slice_width`` compute it the way the wide
    kernels do (:func:`flash_fwd_wide_reference`).  Returns ``out`` (B, S,
    H, D)."""
    out, _, _ = _forward_tiles(q, k, v, mask_i8, k_hi, None, block_q,
                               block_k, 0.0, scale=scale, chunk=chunk,
                               slice_width=slice_width)
    return out[:, :, :q.shape[1]].permute(0, 2, 1, 3).to(q.dtype)


def _out_dtype(x: torch.Tensor, out_dtype):
    """The dtype a kernel writes: ``out_dtype`` (None or float32) or x's."""
    if out_dtype not in (None, torch.float32):
        raise ValueError(f"out_dtype must be None or torch.float32, got "
                         f"{out_dtype}")
    return out_dtype or x.dtype


def flash_fwd_lse_reference(q, k, v, mask_i8, k_hi, seed=None, *,
                            block_q: int, block_k: int,
                            dropout_rate: float = 0.0, out_dtype=None,
                            b0: int = 0, h0: int = 0,
                            heads_total: Optional[int] = None,
                            scale: Optional[float] = None,
                            chunk: Optional[int] = None,
                            slice_width: Optional[int] = None):
    """Plain version of the forward kernel with LSE.

    Arguments as :func:`flash_fwd_reference`; ``seed`` (2,) int64 words,
    ``b0``, the batch's first global row, and ``h0`` / ``heads_total``,
    the first of the call's heads among all heads (dropout only).  The
    accumulator takes ``keep * p / (1 - r)`` cast to
    v's dtype while ``l`` and the LSE use the undropped p.  Returns ``out``
    (B, S, H, D) in q's dtype (float32 with ``out_dtype=torch.float32``,
    the cast skipped) and ``lse`` (B, H, S_pad) float32."""
    dtype = _out_dtype(q, out_dtype)
    out, m, l_safe = _forward_tiles(q, k, v, mask_i8, k_hi, seed, block_q,
                                    block_k, dropout_rate, b0, h0,
                                    heads_total, scale, chunk, slice_width)
    lse = (m + torch.log(l_safe))[..., 0]
    return out[:, :, :q.shape[1]].permute(0, 2, 1, 3).to(dtype), lse


def attention_delta(do: torch.Tensor, out: torch.Tensor,
                    s_pad: int) -> torch.Tensor:
    """delta = rowsum(dO * O) as float32 (B, H, S_pad), zero-padded; the
    JAX package computes it outside the kernels too."""
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
    return F.pad(delta, (0, s_pad - delta.shape[-1])).contiguous()


def _probs(qf, kf, lse, mask_i8, rq, rk, scale, chunk=None):
    """exp(s - lse) of the live rows, 0 elsewhere (the backward kernels'
    recomputed weights)."""
    sc = _logits(qf[:, :, rq], kf[:, :, rk], chunk) * scale
    sc = torch.where(mask_i8[rq, rk] != 0, sc, NEG_INF)
    row_lse = lse[:, :, rq, None]
    return torch.where(row_lse > 0.25 * NEG_INF, torch.exp(sc - row_lse),
                       0.0)


def flash_dq_reference(q, k, v, do, lse, delta, mask_i8, k_hi, seed=None, *,
                       block_q: int, block_k: int,
                       dropout_rate: float = 0.0, out_dtype=None,
                       b0: int = 0, h0: int = 0,
                       heads_total: Optional[int] = None,
                       scale: Optional[float] = None,
                       chunk: Optional[int] = None,
                       slice_width: Optional[int] = None):
    """Plain version of the dq kernel: per q tile over the key tiles below
    ``k_hi``, ``p = exp(s - lse)`` on live rows, ``dp = dO V^T`` (kept and
    rescaled under dropout), ``ds = p (dp - delta)`` cast to k's dtype,
    ``dq = sm_scale * ds K`` (sm_scale: ``scale``, default 1/sqrt(D)).
    ``chunk`` and ``slice_width`` compute it the way the wide kernels do.
    Returns dq (B, S, H, D) in q's dtype, or float32 with
    ``out_dtype=torch.float32``."""
    dtype = _out_dtype(q, out_dtype)
    b, s, h, d = q.shape
    s_pad = mask_i8.shape[0]
    scale = scale or 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (_heads_first(x, s_pad) for x in (q, k, v, do))
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    dq = torch.zeros(b, h, s_pad, d, device=q.device)
    slices = _slices(d, slice_width)
    for qi, hi in enumerate(k_hi.tolist()):
        rq = slice(qi * block_q, (qi + 1) * block_q)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for ki in range(hi):
            rk = slice(ki * block_k, (ki + 1) * block_k)
            p = _probs(qf, kf, lse, mask_i8, rq, rk, scale, chunk)
            dp = _logits(dof[:, :, rq], vf[:, :, rk], chunk)
            if dropout_rate > 0:
                keep = dropout_keep_mask(seed, b, h,
                                         _rows(qi, block_q, q.device),
                                         _rows(ki, block_k, q.device),
                                         dropout_rate, b0, h0, heads_total)
                dp = torch.where(keep, dp, 0.0) * inv_keep
            ds = (p * (dp - delta[:, :, rq, None])).to(k.dtype).float()
            for cols in slices:
                acc[..., cols] = acc[..., cols] + ds @ kf[:, :, rk, cols]
        dq[:, :, rq] = acc * scale
    return dq[:, :, :s].permute(0, 2, 1, 3).to(dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, mask_i8, q_lo, seed=None,
                        *, block_q: int, block_k: int,
                        dropout_rate: float = 0.0, out_dtype=None,
                        b0: int = 0, h0: int = 0,
                        heads_total: Optional[int] = None,
                        scale: Optional[float] = None,
                        chunk: Optional[int] = None,
                        slice_width: Optional[int] = None):
    """Plain version of the dk/dv kernel: per key tile over the q tiles
    from ``q_lo``, ``dv += (keep p / (1 - r))^T dO`` with the weights cast
    to dO's dtype, ``dk += ds^T Q`` with ``ds`` cast to q's dtype, dk times
    sm_scale.  ``chunk`` and ``slice_width`` compute it the way the wide
    kernels do.  Returns (dk, dv) (B, S, H, D) in k's and v's dtypes, or
    float32 with ``out_dtype=torch.float32``."""
    _out_dtype(q, out_dtype)
    b, s, h, d = q.shape
    s_pad = mask_i8.shape[0]
    num_q = s_pad // block_q
    scale = scale or 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (_heads_first(x, s_pad) for x in (q, k, v, do))
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    dk = torch.zeros(b, h, s_pad, d, device=q.device)
    dv = torch.zeros(b, h, s_pad, d, device=q.device)
    slices = _slices(d, slice_width)
    for ki, lo in enumerate(q_lo.tolist()):
        rk = slice(ki * block_k, (ki + 1) * block_k)
        acc_k = torch.zeros((b, h, block_k, d), device=q.device)
        acc_v = torch.zeros((b, h, block_k, d), device=q.device)
        for qi in range(lo, num_q):
            rq = slice(qi * block_q, (qi + 1) * block_q)
            p = _probs(qf, kf, lse, mask_i8, rq, rk, scale, chunk)
            dp = _logits(dof[:, :, rq], vf[:, :, rk], chunk)
            if dropout_rate > 0:
                keep = dropout_keep_mask(seed, b, h,
                                         _rows(qi, block_q, q.device),
                                         _rows(ki, block_k, q.device),
                                         dropout_rate, b0, h0, heads_total)
                p_drop = torch.where(keep, p, 0.0) * inv_keep
                dp = torch.where(keep, dp, 0.0) * inv_keep
            else:
                p_drop = p
            pt = p_drop.to(do.dtype).float().transpose(-1, -2)
            ds = (p * (dp - delta[:, :, rq, None])).to(q.dtype).float()
            for cols in slices:
                acc_v[..., cols] = acc_v[..., cols] + pt @ dof[:, :, rq, cols]
                acc_k[..., cols] = (acc_k[..., cols]
                                    + ds.transpose(-1, -2) @ qf[:, :, rq,
                                                                cols])
        dk[:, :, rk] = acc_k * scale
        dv[:, :, rk] = acc_v
    unflat = lambda x, like: x[:, :, :s].permute(0, 2, 1, 3).to(
        _out_dtype(like, out_dtype))
    return unflat(dk, k), unflat(dv, v)


def _wide_kw(kind, q):
    """The wide kernel's cut of D for a plain version on q's dtype and head
    dim: its reduction chunks and output slices (64 columns each in
    float32; in 16 bits by :func:`wide_forward_plan` and
    :func:`wide_backward_plan`)."""
    if q.dtype == torch.float32:
        return dict(chunk=64, slice_width=64)
    plan = (wide_forward_plan(q.shape[-1]) if kind == "fwd" else
            wide_backward_plan(kind, q.shape[-1]))
    return dict(chunk=plan["chunk"], slice_width=plan["slice"])


def flash_fwd_wide_reference(q, k, v, mask_i8, k_hi, **kw):
    """:func:`flash_fwd_reference` computed the way the wide forward kernel
    does: logits summed over D in its chunks, in order (up to
    ``WIDE_CLUSTER_MAX`` slices the slices' partials, ``WIDE_CHUNKS``),
    and the output in slices (``WIDE_SLICES``)."""
    return flash_fwd_reference(q, k, v, mask_i8, k_hi,
                               **_wide_kw("fwd", q), **kw)


def flash_fwd_lse_wide_reference(q, k, v, mask_i8, k_hi, seed=None, **kw):
    """:func:`flash_fwd_lse_reference` the way the wide kernel computes
    it (as :func:`flash_fwd_wide_reference`)."""
    return flash_fwd_lse_reference(q, k, v, mask_i8, k_hi, seed,
                                   **_wide_kw("fwd", q), **kw)


def flash_dq_wide_reference(q, k, v, do, lse, delta, mask_i8, k_hi,
                            seed=None, **kw):
    """:func:`flash_dq_reference` the way the wide kernel computes it:
    logits and dO V^T summed over D in chunks, dQ in slices."""
    return flash_dq_reference(q, k, v, do, lse, delta, mask_i8, k_hi, seed,
                              **_wide_kw("dq", q), **kw)


def flash_dkv_wide_reference(q, k, v, do, lse, delta, mask_i8, q_lo,
                             seed=None, **kw):
    """:func:`flash_dkv_reference` the way the wide kernel computes it:
    the transposed logits and dP summed over D in chunks, dK and dV in
    slices."""
    return flash_dkv_reference(q, k, v, do, lse, delta, mask_i8, q_lo, seed,
                               **_wide_kw("dkv", q), **kw)


def xla_reference_attention(q, k, v, mask_bool: torch.Tensor, *,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[torch.Tensor] = None):
    """Plain masked attention with the materialized weights (the JAX
    package's ``_xla_reference_attention``): float32 logits and softmax,
    dead rows (no allowed key) give zero weights, the weights return to
    q's dtype.  With ``dropout_rate`` the kernels' keep mask is applied to
    the normalized weights, scaled by 1/(1-r).  Differentiable by autograd."""
    b, s, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    logits = torch.where(mask_bool[None, None], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    live = mask_bool.any(dim=1)[None, None, :, None]
    weights = torch.where(live, weights, 0.0)
    if dropout_rate > 0:
        idx = torch.arange(s, device=q.device)
        keep = dropout_keep_mask(dropout_seed, b, h, idx, idx, dropout_rate)
        weights = torch.where(keep, weights, 0.0) * (1.0 / (1.0 - dropout_rate))
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)


# -- kernel wrappers --------------------------------------------------------------

def _library(wide: bool = False):
    """The kernel library (``csrc/flash_attention.cu``, or
    ``csrc/flash_attention_wide.cu`` with ``wide``) with its C signatures
    declared; both take the same arguments."""
    lib = _build.load_library("flash_attention_wide" if wide
                              else "flash_attention")
    if not getattr(lib, "_signatures_set", False):
        vp, ci, cf, cu = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32)
        # pointers, then batch, seq, heads, head_dim, s_pad, dtype, scale,
        # inv_keep, threshold, dropout, out_f32, b0, h0, heads_total, stream
        tail = [ci] * 6 + [cf, cf, cu, ci, ci, ci, ci, ci, vp]
        # no seed, no LSE, no dropout arguments
        args = {"flash_fwd": [vp] * 6 + [ci] * 6 + [cf, vp],
                "flash_fwd_lse": [vp] * 8 + tail,
                "flash_dq": [vp] * 10 + tail,
                "flash_dkv": [vp] * 11 + tail}
        lib.launch = {}
        for kernel, types in args.items():
            fn = getattr(lib, f"{kernel}{'_wide' if wide else ''}_launch")
            fn.argtypes, fn.restype = types, ci
            lib.launch[kernel] = fn
        lib.error_string = (lib.flash_wide_error_string if wide
                            else lib.flash_error_string)
        lib.error_string.argtypes = [ci]
        lib.error_string.restype = ctypes.c_char_p
        lib._signatures_set = True
    return lib


def _prepare(name, q, k, v, others, mask_i8, table, seed, block_q, block_k,
             dropout_rate, scale):
    """Check what the kernel takes and return its scalar arguments."""
    b, s, h, d = q.shape
    if d <= 0 or compiled_head_dim(d) != d:
        raise ValueError(f"{name}: head dim {d} not compiled; the kernels "
                         f"take {sorted(KERNEL_TILES)} and the multiples of "
                         f"{WIDE_CHUNK} above {max(KERNEL_TILES)}")
    if (block_q, block_k) != kernel_tiles(d):
        raise ValueError(f"{name}: tiles ({block_q}, {block_k}) at head dim "
                         f"{d}; the kernel is compiled for "
                         f"{kernel_tiles(d)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    for t in (k, v, *others):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: operands must share q's shape "
                             f"{tuple(q.shape)} and dtype {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    s_pad = mask_i8.shape[0]
    if (mask_i8.dtype != torch.int8 or tuple(mask_i8.shape) != (s_pad, s_pad)
            or s_pad < s or s_pad % block_q or s_pad % block_k):
        raise ValueError(f"{name}: mask {tuple(mask_i8.shape)} "
                         f"{mask_i8.dtype} is not a tile-aligned int8 square "
                         f"of side >= {s}")
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: skip table must be int32")
    tensors = [q, k, v, *others, mask_i8, table]
    if dropout_rate > 0:
        if seed is None or seed.dtype != torch.int64 or seed.numel() != 2:
            raise ValueError(f"{name}: dropout needs a (2,) int64 seed")
        tensors.append(seed)
    if not on_cuda(*tensors):
        raise RuntimeError(
            f"{name}: the kernel needs all tensors on one sm_90 CUDA "
            f"device; got {sorted({str(t.device) for t in tensors})}")
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    return (b, s, h, d, s_pad, _DTYPE_CODES[q.dtype], scale, inv_keep,
            dropout_threshold(dropout_rate) if dropout_rate > 0 else 0,
            int(dropout_rate > 0),
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(kernel, d, *args):
    """Launch ``kernel`` of the library of head dim ``d`` (the wide one
    above 256) and count it in its wrapper's ``.launches``."""
    wide = is_wide(d)
    lib = _library(wide)
    rc = lib.launch[kernel](*args)
    name = f"{kernel}_wide" if wide else kernel
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.error_string(rc).decode()}")
    _WRAPPERS[name].launches += 1


def flash_fwd(q, k, v, mask_i8, k_hi, *, block_q: int, block_k: int):
    """Forward without LSE or dropout; arguments and result as for
    :func:`flash_fwd_reference`.  CPU tensors take the plain version; on a
    CUDA device this launches the kernel (at :func:`compiled_head_dim`) or
    raises.  Above head dim 256 it is :func:`flash_fwd_wide`."""
    if is_wide(q.shape[-1]):
        return flash_fwd_wide(q, k, v, mask_i8, k_hi, block_q=block_q,
                              block_k=block_k)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, mask_i8, k_hi, block_q=block_q,
                                   block_k=block_k)
    return at_compiled_dim(_launch_fwd, (q, k, v), mask_i8, k_hi,
                           block_q=block_q, block_k=block_k)


def flash_fwd_wide(q, k, v, mask_i8, k_hi, *, block_q: int, block_k: int):
    """:func:`flash_fwd` by the wide kernel (head dims above 256): its
    plain version :func:`flash_fwd_wide_reference` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_wide_reference(q, k, v, mask_i8, k_hi,
                                        block_q=block_q, block_k=block_k)
    return at_compiled_dim(_launch_fwd, (q, k, v), mask_i8, k_hi,
                           block_q=block_q, block_k=block_k)


def _launch_fwd(q, k, v, mask_i8, k_hi, *, block_q, block_k, scale):
    q, k, v = (x.contiguous() for x in (q, k, v))
    args = _prepare("flash_fwd", q, k, v, (), mask_i8, k_hi, None, block_q,
                    block_k, 0.0, scale)
    out = torch.empty_like(q)
    _launch("flash_fwd", args[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_i8.data_ptr(), k_hi.data_ptr(), out.data_ptr(), *args[:7],
            args[-1])
    return out


def _launch_tail(args, q, out_dtype, b0, h0, heads_total):
    """The launchers' trailing scalars: ``_prepare``'s, with the out_f32
    flag, the batch offset and the head offset and count before the
    stream."""
    heads = args[2]
    total = heads if heads_total is None else heads_total
    if b0 < 0:
        raise ValueError(f"batch offset b0={b0} must be >= 0")
    if h0 < 0 or h0 + heads > total:
        raise ValueError(f"heads [{h0}, {h0 + heads}) outside the "
                         f"{total} heads")
    return (*args[:-1], int(_out_dtype(q, out_dtype) != q.dtype), int(b0),
            int(h0), int(total), args[-1])


def flash_fwd_lse(q, k, v, mask_i8, k_hi, seed=None, *, block_q: int,
                  block_k: int, dropout_rate: float = 0.0, out_dtype=None,
                  b0: int = 0, h0: int = 0, heads_total: Optional[int] = None):
    """Forward with LSE; arguments and results as for
    :func:`flash_fwd_lse_reference`.  CPU tensors take the plain version; on
    a CUDA device this launches the kernel (at :func:`compiled_head_dim`)
    or raises.  Above head dim 256 it is :func:`flash_fwd_lse_wide`."""
    kw = dict(block_q=block_q, block_k=block_k, dropout_rate=dropout_rate,
              out_dtype=out_dtype, b0=b0, h0=h0, heads_total=heads_total)
    if is_wide(q.shape[-1]):
        return flash_fwd_lse_wide(q, k, v, mask_i8, k_hi, seed, **kw)
    if q.device.type == "cpu":
        return flash_fwd_lse_reference(q, k, v, mask_i8, k_hi, seed, **kw)
    return at_compiled_dim(_launch_fwd_lse, (q, k, v), mask_i8, k_hi, seed,
                           **kw)


def flash_fwd_lse_wide(q, k, v, mask_i8, k_hi, seed=None, **kw):
    """:func:`flash_fwd_lse` by the wide kernel (head dims above 256): its
    plain version :func:`flash_fwd_lse_wide_reference` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_lse_wide_reference(q, k, v, mask_i8, k_hi, seed,
                                            **kw)
    return at_compiled_dim(_launch_fwd_lse, (q, k, v), mask_i8, k_hi, seed,
                           **kw)


def _launch_fwd_lse(q, k, v, mask_i8, k_hi, seed, *, block_q, block_k,
                    scale, dropout_rate=0.0, out_dtype=None, b0=0, h0=0,
                    heads_total=None):
    q, k, v = (x.contiguous() for x in (q, k, v))
    args = _prepare("flash_fwd_lse", q, k, v, (), mask_i8, k_hi, seed,
                    block_q, block_k, dropout_rate, scale)
    b, _, h, _, s_pad = args[:5]
    out = torch.empty_like(q, dtype=_out_dtype(q, out_dtype))
    lse = torch.empty(b, h, s_pad, device=q.device, dtype=torch.float32)
    _launch("flash_fwd_lse", args[3], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), mask_i8.data_ptr(), k_hi.data_ptr(), _ptr(seed),
            out.data_ptr(), lse.data_ptr(),
            *_launch_tail(args, q, out_dtype, b0, h0, heads_total))
    return out, lse


def flash_dq(q, k, v, do, lse, delta, mask_i8, k_hi, seed=None, *,
             block_q: int, block_k: int, dropout_rate: float = 0.0,
             out_dtype=None, b0: int = 0, h0: int = 0,
             heads_total: Optional[int] = None):
    """dQ; arguments and result as for :func:`flash_dq_reference`.  Above
    head dim 256 it is :func:`flash_dq_wide`."""
    kw = dict(block_q=block_q, block_k=block_k, dropout_rate=dropout_rate,
              out_dtype=out_dtype, b0=b0, h0=h0, heads_total=heads_total)
    if is_wide(q.shape[-1]):
        return flash_dq_wide(q, k, v, do, lse, delta, mask_i8, k_hi, seed,
                             **kw)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, mask_i8, k_hi,
                                  seed, **kw)
    return at_compiled_dim(_launch_dq, (q, k, v, do), lse, delta, mask_i8,
                           k_hi, seed, **kw)


def flash_dq_wide(q, k, v, do, lse, delta, mask_i8, k_hi, seed=None, **kw):
    """:func:`flash_dq` by the wide kernel (head dims above 256): its plain
    version :func:`flash_dq_wide_reference` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_dq_wide_reference(q, k, v, do, lse, delta, mask_i8,
                                       k_hi, seed, **kw)
    return at_compiled_dim(_launch_dq, (q, k, v, do), lse, delta, mask_i8,
                           k_hi, seed, **kw)


def _launch_dq(q, k, v, do, lse, delta, mask_i8, k_hi, seed, *, block_q,
               block_k, scale, dropout_rate=0.0, out_dtype=None, b0=0, h0=0,
               heads_total=None):
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    args = _prepare("flash_dq", q, k, v, (do,), mask_i8, k_hi, seed,
                    block_q, block_k, dropout_rate, scale)
    _check_stats(lse, delta, args)
    dq = torch.empty_like(q, dtype=_out_dtype(q, out_dtype))
    _launch("flash_dq", args[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask_i8.data_ptr(), k_hi.data_ptr(), _ptr(seed), dq.data_ptr(),
            *_launch_tail(args, q, out_dtype, b0, h0, heads_total))
    return dq


def flash_dkv(q, k, v, do, lse, delta, mask_i8, q_lo, seed=None, *,
              block_q: int, block_k: int, dropout_rate: float = 0.0,
              out_dtype=None, b0: int = 0, h0: int = 0,
              heads_total: Optional[int] = None):
    """(dK, dV); arguments and results as for :func:`flash_dkv_reference`.
    Above head dim 256 it is :func:`flash_dkv_wide`."""
    kw = dict(block_q=block_q, block_k=block_k, dropout_rate=dropout_rate,
              out_dtype=out_dtype, b0=b0, h0=h0, heads_total=heads_total)
    if is_wide(q.shape[-1]):
        return flash_dkv_wide(q, k, v, do, lse, delta, mask_i8, q_lo, seed,
                              **kw)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, mask_i8, q_lo,
                                   seed, **kw)
    return at_compiled_dim(_launch_dkv, (q, k, v, do), lse, delta, mask_i8,
                           q_lo, seed, **kw)


def flash_dkv_wide(q, k, v, do, lse, delta, mask_i8, q_lo, seed=None, **kw):
    """:func:`flash_dkv` by the wide kernel (head dims above 256): its
    plain version :func:`flash_dkv_wide_reference` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_dkv_wide_reference(q, k, v, do, lse, delta, mask_i8,
                                        q_lo, seed, **kw)
    return at_compiled_dim(_launch_dkv, (q, k, v, do), lse, delta, mask_i8,
                           q_lo, seed, **kw)


def _launch_dkv(q, k, v, do, lse, delta, mask_i8, q_lo, seed, *, block_q,
                block_k, scale, dropout_rate=0.0, out_dtype=None, b0=0,
                h0=0, heads_total=None):
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    args = _prepare("flash_dkv", q, k, v, (do,), mask_i8, q_lo, seed,
                    block_q, block_k, dropout_rate, scale)
    _check_stats(lse, delta, args)
    dk = torch.empty_like(k, dtype=_out_dtype(k, out_dtype))
    dv = torch.empty_like(v, dtype=_out_dtype(v, out_dtype))
    _launch("flash_dkv", args[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask_i8.data_ptr(), q_lo.data_ptr(), _ptr(seed), dk.data_ptr(),
            dv.data_ptr(),
            *_launch_tail(args, q, out_dtype, b0, h0, heads_total))
    return dk, dv


def flash_bwd(q, k, v, do, lse, delta, mask_i8, k_hi, q_lo, *, block_q: int,
              block_k: int, out_dtype=None):
    """(dQ, dK, dV) by the dq and dk/dv kernels with the mask tile and both
    skip tables handed in: the ring-step counterpart of
    :func:`flash_fwd_lse` (the JAX package's ``flash_bwd``).  ``lse`` and
    ``delta`` are the (B, H, S_pad) statistics of the whole softmax, merged
    across the ring's steps; ``out_dtype=torch.float32`` keeps the partials
    unrounded.  No dropout."""
    kw = dict(block_q=block_q, block_k=block_k, out_dtype=out_dtype)
    dq = flash_dq(q, k, v, do, lse, delta, mask_i8, k_hi, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, mask_i8, q_lo, **kw)
    return dq, dk, dv


def _check_stats(lse, delta, args):
    b, _, h, _, s_pad = args[:5]
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != (b, h, s_pad) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device.type != "cuda"):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{(b, h, s_pad)} on the card; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")


_WRAPPERS = {f.__name__: f for f in (
    flash_fwd, flash_fwd_lse, flash_dq, flash_dkv, flash_fwd_wide,
    flash_fwd_lse_wide, flash_dq_wide, flash_dkv_wide)}
for _wrapper in _WRAPPERS.values():
    _wrapper.launches = 0


@torch.library.custom_op("tokenmerge::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask_i8: torch.Tensor, k_hi: torch.Tensor, block_q: int,
                 block_k: int) -> torch.Tensor:
    """:func:`flash_fwd` as the custom op ``tokenmerge::flash_fwd``, the
    name an exported program (``serve.export``) holds; the attention hook
    calls it."""
    return flash_fwd(q, k, v, mask_i8, k_hi, block_q=block_q,
                     block_k=block_k)


@flash_fwd_op.register_fake
def _(q, k, v, mask_i8, k_hi, block_q, block_k):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# -- differentiable entry -----------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Forward with LSE, backward by the dq and dk/dv kernels (the JAX
    package's ``_flash_attention_vjp_native``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_i8, k_hi, q_lo, seed, block_q, block_k,
                dropout_rate, b0, h0, heads_total):
        out, lse = flash_fwd_lse(q, k, v, mask_i8, k_hi, seed,
                                 block_q=block_q, block_k=block_k,
                                 dropout_rate=dropout_rate, b0=b0, h0=h0,
                                 heads_total=heads_total)
        ctx.save_for_backward(q, k, v, out, lse, mask_i8, k_hi, q_lo)
        ctx.seed = seed
        ctx.config = (block_q, block_k, dropout_rate, b0, h0, heads_total)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, mask_i8, k_hi, q_lo = ctx.saved_tensors
        block_q, block_k, rate, b0, h0, heads_total = ctx.config
        g = g.contiguous()
        # with dropout O already holds the dropped weights, so delta =
        # rowsum(dO * O) still equals sum_j P_ij dP_ij
        delta = attention_delta(g, out, mask_i8.shape[0])
        kw = dict(block_q=block_q, block_k=block_k, dropout_rate=rate, b0=b0,
                  h0=h0, heads_total=heads_total)
        dq = flash_dq(q, k, v, g, lse, delta, mask_i8, k_hi, ctx.seed, **kw)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, mask_i8, q_lo, ctx.seed,
                           **kw)
        return (dq, dk, dv) + (None,) * 10


class _FlashAttentionRecompute(torch.autograd.Function):
    """Forward by the kernel without LSE, backward by autograd through
    :func:`xla_reference_attention` on the saved q, k, v (the JAX package's
    ``_flash_attention_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_i8, k_hi, block_q, block_k):
        ctx.save_for_backward(q, k, v, mask_i8)
        return flash_fwd_op(q, k, v, mask_i8, k_hi, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask_i8 = ctx.saved_tensors
        s = q.shape[1]
        mask_bool = mask_i8[:s, :s] != 0
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = xla_reference_attention(*qkv, mask_bool)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None


def _check_mode(backward: str, dropout_rate: float):
    if backward not in ("pallas", "xla"):
        raise ValueError(f"unknown backward {backward!r}")
    if dropout_rate > 0.0:
        if backward != "pallas":
            raise ValueError("flash attention dropout requires "
                             "backward='pallas'")
        if not dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {dropout_rate} not in (0, 1)")


def _attend(q, k, v, mask: np.ndarray, tables, block_q, block_k, backward,
            dropout_rate, dropout_seed):
    """The autograd function of ``backward`` on the mask's ``tables``."""
    s = q.shape[1]
    if mask.shape != (s, s):
        raise ValueError(f"mask shape {mask.shape} != ({s}, {s})")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    mask_i8, k_hi, q_lo = tables
    if backward == "xla":
        return _FlashAttentionRecompute.apply(q, k, v, mask_i8, k_hi,
                                              block_q, block_k)
    if dropout_rate == 0.0:
        return _FlashAttention.apply(q, k, v, mask_i8, k_hi, q_lo, None,
                                     block_q, block_k, 0.0, 0, 0, None)
    # inside a data-parallel step the rank's first row of the global batch,
    # inside a tensor-parallel attention its first head of all heads
    h0, heads_total = head_offset(q.shape[2])
    return _FlashAttention.apply(q, k, v, mask_i8, k_hi, q_lo, dropout_seed,
                                 block_q, block_k, dropout_rate,
                                 row_offset(q.shape[0]), h0, heads_total)


def flash_attention(q, k, v, mask: np.ndarray, *,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None, backward: str = "pallas",
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None):
    """Masked multi-head attention (B, S, H, D) -> (B, S, H, D) under a
    static numpy bool (S, S) mask (queries attend to keys where True).

    Differentiable; ``backward='pallas'`` runs the dq and dk/dv kernels on
    the saved LSE.  ``backward='xla'`` runs the forward kernel that saves no
    LSE and recomputes the gradients through
    :func:`xla_reference_attention`; it takes no dropout.
    ``dropout_rate`` > 0 drops attention weights after the softmax with the
    Philox mask of ``dropout_seed`` ((2,) int64 words on q's device), of
    the rows of the global batch this call holds (``row_offset``) and of
    its heads among all heads (``head_offset``).
    Tiles (:func:`run_tiles`): on a CUDA device the card's, whatever is
    handed in; CPU tensors take the plain versions at any tiles, the
    card's by default."""
    if not isinstance(mask, np.ndarray):
        raise TypeError("flash_attention requires a static numpy mask")
    block_q, block_k = run_tiles(q.shape[-1], q.device, block_q, block_k)
    dropout_rate = float(dropout_rate)
    _check_mode(backward, dropout_rate)
    return _attend(q, k, v, mask,
                   device_tables(mask, block_q, block_k, q.device), block_q,
                   block_k, backward, dropout_rate, dropout_seed)


def draw_dropout_seed(generator: torch.Generator) -> torch.Tensor:
    """Two 32-bit Philox key words, as a (2,) int64 tensor on the
    generator's device (no host round trip)."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def make_attention_fn(mask: np.ndarray, *, block_q: Optional[int] = None,
                      block_k: Optional[int] = None,
                      backward: str = "pallas", dropout_rate: float = 0.0):
    """The ``attention_fn`` hook of ``modules.attention.MultiHeadAttention``:
    ``fn(q, k, v, mask_ignored=None, dropout_generator=None)``.  With a
    generator and ``dropout_rate`` > 0 it draws the seed words from it and
    drops weights in the kernel; without one it runs deterministically.
    The hook owns its mask's device tables: built once per (head dim,
    device), at the first call or ahead of it by ``fn.tables_for(head_dim,
    device)``, so no call hashes the mask; at :func:`run_tiles` (the
    card's tiles on a CUDA device, whatever tiles are handed in)."""
    if not isinstance(mask, np.ndarray):
        raise TypeError("flash attention requires a static numpy mask")
    dropout_rate = float(dropout_rate)
    _check_mode(backward, dropout_rate)
    tables = {}

    def tables_for(head_dim: int, device):
        bq, bk = run_tiles(head_dim, device, block_q, block_k)
        key = (bq, bk, _resolve_device(device))
        if key not in tables:
            tables[key] = _build_tables(mask, bq, bk, key[2])
        return bq, bk, tables[key]

    def attention_fn(q, k, v, _mask_ignored=None, dropout_generator=None):
        rate = dropout_rate if dropout_generator is not None else 0.0
        seed = draw_dropout_seed(dropout_generator) if rate > 0 else None
        bq, bk, held = tables_for(q.shape[-1], q.device)
        return _attend(q, k, v, mask, held, bq, bk, backward, rate, seed)

    attention_fn.tables_for = tables_for
    return attention_fn
