"""ToMe token merging: bipartite soft matching and the weighted-average
merge.

Counterpart of the JAX package's ``ops/tome.py``.  ``r`` is a Python int,
so the merged sequence has the static length ``t - r``.

Which tokens merge is a discrete choice, so the tie rules of the JAX
functions are reproduced, not left to ``torch.topk``:

* each source token's partner is the FIRST maximum of its score row
  (``argmax``);
* ``ordering='score'`` ranks sources by a stable ascending sort reversed,
  so among equal scores the HIGHER index ranks first;
* ``ordering='stable'`` takes ``top_k`` (``ops.pruning.top_k_order``:
  ``+0.0`` above ``-0.0``, the LOWER index first among equal scores), and
  keeps the unmerged tokens in their original order.  ``'score'``'s
  ``argsort`` ties the two zeros, as ``jnp.argsort`` does.

The merge sums the ``r`` sources of each destination in one one-hot
product accumulated in float32 and rounded once to the tokens' dtype
before the add (the JAX einsum at ``Precision.HIGHEST``); it is
deterministic, which ``index_add_`` on a CUDA device is not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .pruning import top_k_order

__all__ = ["BipartiteMatching", "bipartite_soft_matching", "apply_merge",
           "merge_wavg"]


class BipartiteMatching(NamedTuple):
    """Gather / scatter plan of one merge.

    ``unm_idx`` (B, t_a - r, 1): indices into the even (source) half, kept.
    ``src_idx`` (B, r, 1): indices into the even half, merged away.
    ``dst_idx`` (B, r, 1): indices into the odd (destination) half that
    each merged token joins.  ``distill``: a distill token is protected at
    dst position 0, and :func:`apply_merge` interleaves it to output
    position 1.  Indices are int64.
    """

    unm_idx: torch.Tensor
    src_idx: torch.Tensor
    dst_idx: torch.Tensor
    r: int
    distill: bool = False


@torch.no_grad()
def bipartite_soft_matching(metric: torch.Tensor, r: int,
                            class_token: bool = False,
                            distill_token: bool = False,
                            ordering: str = "score"
                            ) -> Optional[BipartiteMatching]:
    """The merge plan of a (B, T, C) similarity metric, or None when
    ``r <= 0``.  Raises when ``r > (T - protected) // 2``."""
    protected = int(class_token) + int(distill_token)
    t = metric.shape[1]
    if r <= 0:
        return None
    if r > (t - protected) // 2:
        raise ValueError(
            f"cannot merge r={r} of {t} tokens (max {(t - protected) // 2})")
    if ordering not in ("score", "stable"):
        raise ValueError(f"unknown ordering {ordering!r}")

    metric = metric / torch.linalg.vector_norm(metric, dim=-1, keepdim=True)
    a, b = metric[..., ::2, :], metric[..., 1::2, :]
    scores = a @ b.transpose(-1, -2)                      # (B, Ta, Tb)
    if class_token:
        scores[..., 0, :] = -torch.inf
    if distill_token:
        scores[..., :, 0] = -torch.inf

    node_max, node_idx = scores.max(dim=-1)               # first maximum
    if ordering == "score":
        edge_idx = torch.sort(node_max, dim=-1, stable=True).indices.flip(-1)
        unm_idx = edge_idx[..., r:]
        src_idx = edge_idx[..., :r]
    else:
        order = top_k_order(node_max)
        src_idx = order[..., :r]
        unm_idx = torch.sort(order[..., r:], dim=-1).values
    dst_idx = torch.gather(node_idx, -1, src_idx)
    return BipartiteMatching(unm_idx[..., None], src_idx[..., None],
                             dst_idx[..., None], r, distill_token)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.expand(-1, -1, x.shape[-1]))


def apply_merge(plan: Optional[BipartiteMatching], x: torch.Tensor,
                mode: str = "sum") -> torch.Tensor:
    """Apply a merge plan to (B, T, C) tokens -> (B, T - r, C): the kept
    sources, then the destinations with their merged sources added
    (``'sum'``) or dropped (``'keep'``)."""
    if plan is None:
        return x
    if mode not in ("sum", "keep"):
        raise ValueError(f"unknown merge mode {mode!r}")
    src_half = x[..., ::2, :]
    dst = x[..., 1::2, :]
    unm = _take(src_half, plan.unm_idx)
    if mode == "sum":
        src = _take(src_half, plan.src_idx)
        # (B, n_dst, r) one-hot by comparison: F.one_hot reads its indices'
        # range back to the host, a device synchronization per merge
        slots = torch.arange(dst.shape[1], device=x.device)[:, None]
        onehot = (plan.dst_idx.transpose(1, 2) == slots).float()
        dst = dst + (onehot @ src.float()).to(x.dtype)
    if plan.distill:
        return torch.cat([unm[:, :1], dst[:, :1], unm[:, 1:], dst[:, 1:]],
                         dim=1)
    return torch.cat([unm, dst], dim=1)


def merge_wavg(plan: Optional[BipartiteMatching], x: torch.Tensor,
               size: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Size-weighted average merge.  ``size`` (B, T, 1) counts the original
    tokens each current token stands for, in x's dtype; merged embeddings
    stay at the original scale."""
    if size is None:
        size = torch.ones_like(x[..., :1])
    if plan is None:
        return x, size
    x = apply_merge(plan, x * size, mode="sum")
    size = apply_merge(plan, size, mode="sum")
    return x / size, size
