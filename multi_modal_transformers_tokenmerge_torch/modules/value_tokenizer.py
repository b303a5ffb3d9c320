"""Discrete / continuous value tokenization.

Counterpart of the JAX package's ``modules/value_tokenizer.py``:
:class:`ActionTokenizer` embeds discrete action indices, and mu-law
companding maps continuous values into [-1, 1] and back.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Embed

__all__ = ["ActionTokenizer", "mu_law_encode", "mu_law_decode"]


class ActionTokenizer(nn.Module):
    """Embeds discrete action indices: int (...,) -> (..., embedding_dim)
    in the compute dtype.  The table is ``action_embedding`` (the flax
    name)."""

    def __init__(self, num_actions: int, embedding_dim: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.action_embedding = Embed(num_actions, embedding_dim,
                                      dtype=dtype, param_dtype=param_dtype,
                                      device=device)

    def forward(self, action: torch.Tensor) -> torch.Tensor:
        return self.action_embedding(action)


def mu_law_encode(x: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    """Mu-law companding of continuous values."""
    return torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)


def mu_law_decode(y: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    """Inverse companding."""
    return torch.sign(y) * torch.expm1(y.abs() * math.log1p(mu)) / mu
