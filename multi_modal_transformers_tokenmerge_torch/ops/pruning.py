"""Attention-importance token pruning: per-token-set top-k selection.

Counterpart of the JAX package's ``ops/pruning.py``.  The token counts per
set are Python ints from the sequence layout, so the pruned sequence has a
static shape.  Among equal scores the lower index is kept first, as
``jax.lax.top_k`` does (``torch.topk`` promises no order): the selection is
a stable descending sort.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["topk_tokens_per_set", "prune_gather"]


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
        idx = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :k]
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
