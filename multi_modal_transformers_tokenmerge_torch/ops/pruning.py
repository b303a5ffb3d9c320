"""Attention-importance token pruning: per-token-set top-k selection.

Counterpart of the JAX package's ``ops/pruning.py``.  The token counts per
set are Python ints from the sequence layout, so the pruned sequence has a
static shape.  The selection is :func:`top_k_order`, ``jax.lax.top_k``'s
order (``torch.topk`` promises none): descending, ``+0.0`` above ``-0.0``,
and among equal scores the lower index first.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["topk_tokens_per_set", "prune_gather", "top_k_order"]


def top_k_order(scores: torch.Tensor) -> torch.Tensor:
    """int64 indices that sort ``scores`` along the last axis as
    ``jax.lax.top_k`` ranks them: descending in the total order of the
    floats, in which ``+0.0`` ranks above ``-0.0`` (a plain float sort
    ties them), equal values keeping the lower index first.  Each value
    is ranked by its float32 bits mapped to an int32 that orders as the
    floats do (the low 31 bits of a negative value flipped)."""
    bits = scores.float().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def topk_tokens_per_set(importance: torch.Tensor,
                        set_slices: Sequence[Tuple[int, int]],
                        keep_counts: Sequence[int],
                        sort_kept: bool = True) -> torch.Tensor:
    """int64 indices (B, sum(keep_counts)) of the kept tokens: for each
    (start, size) set slice the ``k`` tokens of highest ``importance``
    (B, T), offset back into the full sequence.

    ``sort_kept=True`` re-sorts the kept indices ascending, so tokens keep
    their relative order; ``False`` leaves them in descending-importance
    order, and reorders even a set that is kept in full."""
    ids = []
    b = importance.shape[0]
    for (start, size), k in zip(set_slices, keep_counts):
        if k > size:
            raise ValueError(f"cannot keep {k} of {size} tokens")
        if k == size and sort_kept:
            ids.append(torch.arange(start, start + size,
                                    device=importance.device).expand(b, size))
            continue
        scores = importance[:, start:start + size]
        idx = top_k_order(scores)[:, :k]
        if sort_kept:
            idx = torch.sort(idx, dim=-1).values
        ids.append(idx + start)
    return torch.cat(ids, dim=-1)


def prune_gather(x: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
    """Gather kept tokens: (B, T, C), (B, K) -> (B, K, C)."""
    if x.ndim == keep_idx.ndim + 1:
        return torch.gather(x, 1, keep_idx[..., None].expand(
            -1, -1, x.shape[-1]))
    return torch.gather(x, 1, keep_idx)
