"""Ring attention: masked attention with the sequence split into P shards
that pass their keys and values around a ring.

Counterpart of the JAX package's ``parallel/ring_attention.py``.  Each
shard keeps its queries and merges every visiting key/value shard into
per-row online-softmax statistics: the flash kernel's arithmetic across
key tiles, lifted across shards.  The (S, S) mask stays whole on the host;
the (query-shard, key-shard) tiles are cut from it.

The ring is a :class:`~.distributed.Ring`: a process group (one shard a
rank, point-to-point sends to rank + 1) or a :class:`~.distributed.
LocalRing` of P shards in one process, the counterpart of the JAX tests'
virtual devices.  The compute code below runs over the shards a ring holds
and is the same for both.

Two inner blocks:

* ``'xla'`` (plain): float32 logits of input-dtype products, the m / l /
  acc online softmax, each step's tile recomputed in the backward
  (``torch.utils.checkpoint``), zeros for rows with no live key; autograd
  differentiates through the ring (the shift's backward sends gradients
  the other way).
* ``'flash'``: a ``torch.autograd.Function`` whose forward runs
  ``flash_fwd_lse`` on each step with float32 partials (``out_dtype``) and
  merges them with ``logaddexp``; its backward makes a second ring pass of
  ``flash_bwd`` (float32 dq, dk, dv) on the merged LSE and
  ``delta = rowsum(dO * O)``: dq accumulates in place, dk and dv in
  buffers that travel with the key/value shards and take a final shift
  home.  The mask tiles and their ``k_hi`` / ``q_lo`` tables are made once
  per (mask digest, P, tiles, device) and kept on the device.

``'flash'`` needs shard lengths that the kernel's tiles divide
(``kernel_tiles``: 64 x 64 at head dims up to 128 and above 256, 32 x 32
from 129 to 256, a head dim the kernels lack run zero-padded to the next
compiled one; on a CUDA device the card's tiles, whatever tiles are handed
in: ``run_tiles``); ``'auto'`` takes it on an sm_90 card whenever the
shard is aligned, at every head dim, else the plain block.  chip_smoke.py's ring
phase (a ring of 4, forward and backward, bf16, B=2, H=12, D=64, causal)
measured flash ahead of the plain block at every shard it timed, 64 to
2048 tokens, on an NVIDIA H100 80GB HBM3 at 700 W: 8.45x at 64 and 1.56x
at 2048 in time a call, 5.9x and 26x in device time (PERF.md section 6),
so no shard threshold is kept.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.hw import kernel_device
from ..ops.flash_attention import (NEG_INF, _mask_digest, _resolve_device,
                                   attention_delta, flash_bwd, flash_fwd_lse,
                                   run_tiles, tile_skip_tables)
from .distributed import GroupRing, LocalRing, Ring

__all__ = ["ring_attention", "ring_of", "ring_tables", "SEQ_AXIS"]

SEQ_AXIS = "seq"


def ring_of(group_or_mesh, axis: str = SEQ_AXIS) -> Ring:
    """The ring of ``group_or_mesh``: a :class:`Ring` as it is, an int P
    (a :class:`LocalRing` of P shards), a DeviceMesh (its ``axis``), a
    process group, or None (the default group)."""
    if isinstance(group_or_mesh, Ring):
        return group_or_mesh
    if isinstance(group_or_mesh, int):
        return LocalRing(group_or_mesh)
    if hasattr(group_or_mesh, "mesh_dim_names"):
        if axis not in group_or_mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                             f"{group_or_mesh.mesh_dim_names}")
        return GroupRing(group_or_mesh.get_group(axis))
    return GroupRing(group_or_mesh)


_TABLES: "collections.OrderedDict" = collections.OrderedDict()
_TABLES_MAX = 64


def ring_tables(mask: np.ndarray, p: int, block_q: int, block_k: int,
                device):
    """(tiles (P, P, s, s) int8, k_hi (P, P, s/bq) int32, q_lo (P, P, s/bk)
    int32) on ``device`` for shard length s = S / P: the mask tile and the
    skip tables of every (query shard, key shard) pair, cached per (mask
    digest, P, tiles, device), LRU-bounded (the JAX ``_ring_tables``)."""
    device = _resolve_device(device)
    key = (_mask_digest(mask), p, block_q, block_k, str(device))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    s = mask.shape[0] // p
    tiles = np.zeros((p, p, s, s), np.int8)
    khi = np.zeros((p, p, s // block_q), np.int32)
    qlo = np.zeros((p, p, s // block_k), np.int32)
    for i in range(p):
        for j in range(p):
            tiles[i, j] = mask[i * s:(i + 1) * s, j * s:(j + 1) * s]
            khi[i, j], qlo[i, j] = tile_skip_tables(tiles[i, j], block_q,
                                                    block_k)
    with torch.inference_mode(False):
        out = tuple(torch.from_numpy(a).to(device) for a in (tiles, khi, qlo))
    _TABLES[key] = out
    while len(_TABLES) > _TABLES_MAX:
        _TABLES.popitem(last=False)
    return out


def ring_attention(q, k, v, mask: np.ndarray, group_or_mesh,
                   axis: str = SEQ_AXIS, impl: str = "auto",
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None,
                   batch_axis: Optional[str] = None):
    """Masked multi-head attention with the sequence split over a ring.

    ``q, k, v`` (B, S', H, D) are this process's part of the sequence: the
    whole sequence for a :class:`LocalRing` (an int P), the rank's shard
    (S / P consecutive tokens, in rank order) for a process group or mesh.
    ``mask``: static numpy bool (S, S) of the whole sequence, queries
    attend where True.  ``impl``: ``'xla'`` (plain inner block), ``'flash'``
    (the kernels' inner block; raises when the shard length is not a
    multiple of the tiles) or ``'auto'``.  ``block_q``/``block_k``: the
    flash tiles (default, and on a CUDA device always: the kernel's for the
    head dim).  ``batch_axis``:
    a mesh axis the batch is split over (CP x DP); each data slice then
    runs its own ring over ``axis``, so nothing else changes.  Returns
    (B, S', H, D) in q's dtype."""
    if not isinstance(mask, np.ndarray):
        raise TypeError("ring_attention requires a static numpy mask")
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown impl {impl!r}")
    ring = ring_of(group_or_mesh, axis)
    if batch_axis is not None and (
            not hasattr(group_or_mesh, "mesh_dim_names")
            or batch_axis not in group_or_mesh.mesh_dim_names):
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of the "
                         f"mesh")
    p = ring.size
    held = len(ring.indices)
    b, s_here, h, d = q.shape
    s = mask.shape[0]
    if mask.ndim != 2 or mask.shape[1] != s:
        raise ValueError(f"mask shape {mask.shape} is not square")
    if s % p:
        raise ValueError(f"sequence {s} not divisible by ring size {p}")
    if s_here != (s // p) * held:
        raise ValueError(
            f"mask shape {mask.shape} does not fit {held} of {p} shards in "
            f"{s_here} tokens; a wrong-sized mask would cut wrong tiles and "
            f"silently corrupt attention")
    s_local = s // p
    if impl != "xla":
        bq, bk = run_tiles(d, q.device, block_q, block_k)
        aligned = s_local % bq == 0 and s_local % bk == 0
        if aligned and (impl == "flash" or kernel_device(q.device)):
            tables = ring_tables(mask, p, bq, bk, q.device)
            return _RingFlash.apply(q, k, v, ring, tables, bq, bk)
        if impl == "flash":
            raise ValueError(
                f"impl='flash' needs shard length {s_local} divisible by the "
                f"tiles (block_q={bq}, block_k={bk}); use impl='auto' to "
                f"fall back")
    return _ring_plain(q, k, v, mask, ring, s_local)


# -- the plain inner block --------------------------------------------------------

def _merge_block(m, l, acc, q, k_blk, v_blk, tile):
    """One step of the online softmax: (m, l) (B, H, Q) and acc
    (B, H, Q, D) float32, merged with the visiting key block under the
    (Q, K) bool ``tile``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    st = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    st = torch.where(tile[None, None], st, NEG_INF)
    m_new = torch.maximum(m, st.amax(-1))
    # rows with no live key keep m at -1e30: the clamp keeps p = 0 there
    pr = torch.exp(st - torch.clamp_min(m_new, 0.5 * NEG_INF)[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + pr.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", pr.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc_new


def _ring_plain(q, k, v, mask, ring: Ring, s_local: int):
    mask_t = torch.as_tensor(mask, device=q.device)
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    b, _, h, d = q.shape

    def tile(i, src):
        return mask_t[i * s_local:(i + 1) * s_local,
                      src * s_local:(src + 1) * s_local]

    def step(carry, kv, r):
        out = []
        for n, i in enumerate(ring.indices):
            src = (i - r) % ring.size
            out.append(checkpoint(_merge_block, *carry[n], qs[n], kv[n][0],
                                  kv[n][1], tile(i, src),
                                  use_reentrant=False))
        return out

    dev = q.device
    carry = [(torch.full((b, h, s_local), NEG_INF, device=dev),
              torch.zeros((b, h, s_local), device=dev),
              torch.zeros((b, h, s_local, d), device=dev))
             for _ in ring.indices]
    kv = list(zip(ks, vs))
    carry = step(carry, kv, 0)
    for r in range(1, ring.size):
        kv = ring.shift(kv)
        carry = step(carry, kv, r)
    outs = [(acc / torch.clamp_min(l, 1e-30)[..., None]).permute(
        0, 2, 1, 3).to(q.dtype) for _, l, acc in carry]
    return ring.join(outs)


# -- the flash inner block ----------------------------------------------------------

def _fwd_ring(ring: Ring, qs, ks, vs, tables, bq, bk):
    """Per held shard the merged float32 output (B, s, H, D) and LSE
    (B, H, s)."""
    tiles, khi, _ = tables

    def block(i, r, kv_n, q_n):
        src = (i - r) % ring.size
        return flash_fwd_lse(q_n, kv_n[0], kv_n[1], tiles[i, src],
                             khi[i, src], block_q=bq, block_k=bk,
                             out_dtype=torch.float32)

    kv = list(zip(ks, vs))
    acc = [block(i, 0, kv[n], qs[n]) for n, i in enumerate(ring.indices)]
    for r in range(1, ring.size):
        kv = ring.shift(kv)
        nxt = []
        for n, i in enumerate(ring.indices):
            out_acc, lse_acc = acc[n]
            out_j, lse_j = block(i, r, kv[n], qs[n])
            lse_new = torch.logaddexp(lse_acc, lse_j)
            w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
            w_j = torch.exp(lse_j - lse_new).transpose(1, 2)[..., None]
            nxt.append((out_acc * w_acc + out_j * w_j, lse_new))
        acc = nxt
    return acc


def _bwd_ring(ring: Ring, qs, ks, vs, dos, outs, lses, tables, bq, bk):
    """Per held shard (dq, dk, dv) float32 partial sums: dq in place, dk
    and dv travelling with their key/value shard."""
    tiles, khi, qlo = tables
    s_pad = tiles.shape[-1]
    deltas = [attention_delta(do, o, s_pad) for do, o in zip(dos, outs)]

    def block(n, i, r, k_blk, v_blk):
        src = (i - r) % ring.size
        return flash_bwd(qs[n], k_blk, v_blk, dos[n], lses[n], deltas[n],
                         tiles[i, src], khi[i, src], qlo[i, src],
                         block_q=bq, block_k=bk, out_dtype=torch.float32)

    dq, trav = [], []
    for n, i in enumerate(ring.indices):
        dq_n, dk_n, dv_n = block(n, i, 0, ks[n], vs[n])
        dq.append(dq_n)
        trav.append((ks[n], vs[n], dk_n, dv_n))
    for r in range(1, ring.size):
        trav = ring.shift(trav)
        for n, i in enumerate(ring.indices):
            k_blk, v_blk, dk_acc, dv_acc = trav[n]
            dq_j, dk_j, dv_j = block(n, i, r, k_blk, v_blk)
            dq[n] = dq[n] + dq_j
            trav[n] = (k_blk, v_blk, dk_acc + dk_j, dv_acc + dv_j)
    # the travelling sums sit one hop short of home
    home = ring.shift([(t[2], t[3]) for t in trav]) if ring.size > 1 \
        else [(t[2], t[3]) for t in trav]
    return dq, [x[0] for x in home], [x[1] for x in home]


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, tables, bq, bk):
        qs, ks, vs = (ring.split(x.contiguous()) for x in (q, k, v))
        qs, ks, vs = ([x.contiguous() for x in xs] for xs in (qs, ks, vs))
        merged = _fwd_ring(ring, qs, ks, vs, tables, bq, bk)
        out = ring.join([o.to(q.dtype) for o, _ in merged])
        lse = torch.stack([lse for _, lse in merged])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.tables, ctx.tiles_qk = ring, tables, (bq, bk)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        qs, ks, vs, dos, outs = ([x.contiguous() for x in ring.split(t)]
                                 for t in (q, k, v, g.contiguous(), out))
        dq, dk, dv = _bwd_ring(ring, qs, ks, vs, dos, outs, list(lse.unbind()),
                               ctx.tables, *ctx.tiles_qk)
        join = lambda parts, like: ring.join(parts).to(like.dtype)
        return join(dq, q), join(dk, k), join(dv, v), None, None, None, None
