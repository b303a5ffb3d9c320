"""Continuous (tanh-squashed) action head.

Counterpart of the JAX package's ``heads/continuous.py``: the readout
tokens are pooled by their mean or, with ``pooling='map'``, by
``modules.attention.MultiHeadAttentionPooling``, projected to the action
dimension and squashed to ``[-max_action, max_action]``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ContinuousHeadConfig
from ..modules.attention import MultiHeadAttentionPooling
from ..modules.layers import Dense

__all__ = ["ContinuousActionHead"]


class ContinuousActionHead(nn.Module):
    def __init__(self, cfg: ContinuousHeadConfig, readout_dim: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.map_pooling = (MultiHeadAttentionPooling(
            readout_dim, num_heads=cfg.map_num_heads, mlp_dim=readout_dim,
            **kw) if cfg.pooling == "map" else None)
        self.mean = Dense(readout_dim, cfg.action_space_dim, **kw)

    def forward(self, readouts: torch.Tensor) -> torch.Tensor:
        """(B, R, E) readouts -> (B, 1, A) actions."""
        if self.map_pooling is not None:
            emb = self.map_pooling(readouts)[:, 0]
        else:
            emb = readouts.mean(dim=-2)
        mean = self.mean(emb)[:, None, :]
        return torch.tanh(mean / self.cfg.max_action) * self.cfg.max_action
