"""Categorical (binned) action head.

Counterpart of the JAX package's ``heads/categorical.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import CategoricalHeadConfig
from ..modules.layers import Dense

__all__ = ["CategoricalActionHead", "assign_bins"]


def assign_bins(x: torch.Tensor, bounds, num_bins: int,
                bin_strategy: str = "uniform") -> torch.Tensor:
    """Uniform binning as ``jnp.digitize`` over ``num_bins + 1`` edges:
    the int64 index i with ``edges[i-1] <= x < edges[i]``, so in-range
    values map to 1..num_bins, values below the range to 0 and values at or
    above its top to ``num_bins + 1``."""
    if bin_strategy != "uniform":
        raise NotImplementedError(bin_strategy)
    edges = torch.linspace(bounds[0], bounds[1], num_bins + 1,
                           device=x.device)
    return torch.bucketize(x.float().contiguous(), edges, right=True)


class CategoricalActionHead(nn.Module):
    def __init__(self, cfg: CategoricalHeadConfig, readout_dim: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.logits = Dense(readout_dim, cfg.num_bins, **kw)

    def forward(self, readouts: torch.Tensor) -> torch.Tensor:
        """(B, A*T, E) readouts -> (B, A, num_bins) logits (every
        dimension of size 1 squeezed away before the projection, as the
        JAX head does)."""
        b, rt, e = readouts.shape
        a = self.cfg.action_space_dim
        emb = readouts.reshape(b, a, rt // a, e).mean(dim=-2)
        return self.logits(emb.squeeze())
