"""Readout tokens: a learned (1, R, E) parameter broadcast to the batch.
Counterpart of the JAX package's ``modules/readout.py``."""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import init_truncated

__all__ = ["ReadoutTokens"]


class ReadoutTokens(nn.Module):
    CAST_PARAMS = ("pos_embedding",)

    def __init__(self, num_tokens: int, embedding_dim: int, *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.pos_embedding = nn.Parameter(torch.empty(
            1, num_tokens, embedding_dim, dtype=param_dtype, device=device))

    def reset_parameters(self, generator) -> None:
        # flax he_normal on a (1, R, E) shape: fan_in = R
        init_truncated(self.pos_embedding,
                       math.sqrt(2.0 / self.pos_embedding.shape[1]),
                       generator)

    def forward(self, batch_size: int) -> torch.Tensor:
        pe = self.pos_embedding.to(self.dtype)
        return pe.expand(batch_size, *pe.shape[1:])
