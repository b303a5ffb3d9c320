"""Offset attention from the Point Cloud Transformer: ``x + LBR(x -
SelfAttention(x))``.

Counterpart of the JAX package's ``modules/offset_attention.py``: flax's
``MultiHeadDotProductAttention`` (biased query/key/value/out projections,
softmax of q k^T / sqrt(d) where the mask allows), the offset, a Dense, a
flax-semantics ``BatchNorm``, ReLU and the residual.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import AttentionConfig
from .attention import MultiHeadAttention
from .layers import BatchNorm, Dense

__all__ = ["OffsetAttention"]


class OffsetAttention(nn.Module):
    def __init__(self, features: int, num_heads: int, qkv_features: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        # flax's defaults: lecun-normal kernels, zero biases
        self.self_attention = MultiHeadAttention(
            AttentionConfig(num_heads=num_heads, qkv_features=qkv_features,
                            dropout_rate=0.0, use_bias=True), features,
            kernel_init="lecun", bias_init="zeros", **kw)
        self.lbr_dense = Dense(features, features, kernel_init="lecun",
                               bias_init="zeros", **kw)
        self.lbr_bn = BatchNorm(features, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """(B, N, E) -> (B, N, E); ``mask`` broadcastable to (B, H, N, N),
        True = attend."""
        offset = x - self.self_attention(x, mask)
        y = torch.relu(self.lbr_bn(self.lbr_dense(offset), train))
        return y + x
