"""Pre-LN transformer encoder blocks under a static boolean mask.

Counterpart of the JAX package's ``modules/attention.py``.  At the
sequence lengths of this slice the JAX package runs stock XLA attention
(its flash kernel is gated to ``flash_min_seq`` tokens and more), and so
does this module: plain masked softmax attention with float32 logits and
softmax, scaled by 1/sqrt(head_dim).  Dropout is not applied; the port
serves in eval mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.config import AttentionConfig, TransformerConfig
from .layers import Dense, LayerNorm, init_normal

__all__ = ["MLPBlock", "MultiHeadAttention", "EncoderBlock",
           "TransformerStack", "AddPositionEmbedding", "masked_attention"]


def masked_attention(q, k, v, mask: Optional[torch.Tensor]):
    """q, k, v (B, T, H, D) -> (B, T, H, D).  ``mask`` (T, T) bool, True =
    attend.  Float32 logits and softmax; the weights return to v's dtype
    (``jax.nn.dot_product_attention``'s XLA path)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        neg = -0.7 * torch.finfo(torch.float32).max
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class MLPBlock(nn.Module):
    """Dense -> activation -> Dense."""

    def __init__(self, in_dim: int, mlp_dim: int, out_dim: int,
                 activation: str = "relu", **kw):
        super().__init__()
        if activation != "relu":
            raise ValueError(f"unsupported mlp activation {activation!r}")
        self.dense_in = Dense(in_dim, mlp_dim, **kw)
        self.dense_out = Dense(mlp_dim, out_dim, **kw)

    def forward(self, x):
        return self.dense_out(torch.relu(self.dense_in(x)))


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: AttentionConfig, features: int, **kw):
        super().__init__()
        if cfg.qkv_features % cfg.num_heads:
            raise ValueError("qkv_features must divide into num_heads")
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.qkv_features // cfg.num_heads
        proj = lambda: Dense(features, cfg.qkv_features, bias=cfg.use_bias,
                             **kw)
        self.query, self.key, self.value = proj(), proj(), proj()
        self.out = Dense(cfg.qkv_features, features, bias=cfg.use_bias, **kw)

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        split = lambda y: y.reshape(b, t, self.num_heads, self.head_dim)
        out = masked_attention(split(self.query(x)), split(self.key(x)),
                               split(self.value(x)), mask)
        return self.out(out.reshape(b, t, -1))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + mlp(LN(x))."""

    def __init__(self, cfg: TransformerConfig, features: int, **kw):
        super().__init__()
        if cfg.mlp_type != "dense":
            raise ValueError(f"mlp_type {cfg.mlp_type!r} is not ported yet")
        if cfg.layer_norm_reduction == "sequence_compat":
            dim = 1
        elif cfg.layer_norm_reduction == "features":
            dim = -1
        else:
            raise ValueError(
                f"unknown layer_norm_reduction {cfg.layer_norm_reduction!r}")
        ln = lambda: LayerNorm(features, cfg.layer_norm_epsilon, dim, **kw)
        self.ln_attention = ln()
        self.attention = MultiHeadAttention(cfg.attention, features, **kw)
        self.ln_mlp = ln()
        self.mlp = MLPBlock(features, cfg.mlp_dim, features,
                            cfg.mlp_activation, **kw)

    def forward(self, x, mask=None):
        x = x + self.attention(self.ln_attention(x), mask)
        return x + self.mlp(self.ln_mlp(x))


class AddPositionEmbedding(nn.Module):
    """Learned (1, S, E) position embedding added to the sequence."""

    def __init__(self, seq_len: int, features: int, *,
                 param_dtype=torch.float32, device=None, **_):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(
            1, seq_len, features, dtype=param_dtype, device=device))

    def reset_parameters(self, generator) -> None:
        init_normal(self.pos_embedding, 0.02, generator)

    def forward(self, x):
        return x + self.pos_embedding.to(x.dtype)


class TransformerStack(nn.Module):
    """Position embedding + encoder blocks (+ optional final LayerNorm)."""

    def __init__(self, cfg: TransformerConfig, seq_len: int, features: int,
                 **kw):
        super().__init__()
        if cfg.compression_mode != "none":
            raise ValueError("token merging / pruning is not ported yet")
        self.posembed_input = AddPositionEmbedding(seq_len, features, **kw)
        self.blocks = nn.ModuleList(EncoderBlock(cfg, features, **kw)
                                    for _ in range(cfg.num_blocks))
        self.final_norm = (LayerNorm(features, cfg.layer_norm_epsilon, -1,
                                     **kw) if cfg.final_norm else None)

    def forward(self, x, mask=None):
        x = self.posembed_input(x)
        for block in self.blocks:
            x = block(x, mask)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x
