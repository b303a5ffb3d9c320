"""T5 encoder stack (the t5-base architecture).

Counterpart of the JAX package's ``modules/t5.py``: unscaled token
embedding; a bucketed relative-position bias computed once and shared by
all layers; pre-RMSNorm blocks (self-attention with one fused q|k|v
projection and unscaled queries, then a ReLU MLP); a final RMSNorm.
Attention logits and softmax are float32; RMSNorm runs in float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import Dense, Embed

__all__ = ["T5EncoderStack", "T5RMSNorm", "relative_position_bucket"]


def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """T5 bidirectional relative-position bucketing (static, numpy)."""
    ret = np.zeros_like(relative_position)
    n = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n
    rp = np.abs(relative_position)
    max_exact = n // 2
    is_small = rp < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, n - 1)
    ret += np.where(is_small, rp, val_if_large)
    return ret


class T5RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6, *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                               device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        x32 = x32 * torch.rsqrt(var + self.eps)
        return (x32 * self.weight.float()).to(self.dtype)


class T5SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_kv: int, **kw):
        super().__init__()
        self.num_heads, self.d_kv = num_heads, d_kv
        self.dtype = kw["dtype"]
        inner = num_heads * d_kv
        self.qkv = Dense(d_model, 3 * inner, bias=False, kernel_init="lecun",
                         **kw)
        self.o = Dense(inner, d_model, bias=False, kernel_init="lecun", **kw)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor):
        """x (B, T, D); position_bias (H, T, T) float32."""
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, self.d_kv)
        q, k, v = qkv.unbind(2)
        # float32 logits, as preferred_element_type=float32 gives in JAX
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits + position_bias, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.o(out.reshape(b, t, -1))


class T5Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_kv: int, d_ff: int,
                 **kw):
        super().__init__()
        self.attn_norm = T5RMSNorm(d_model, **kw)
        self.attn = T5SelfAttention(d_model, num_heads, d_kv, **kw)
        self.mlp_norm = T5RMSNorm(d_model, **kw)
        self.wi = Dense(d_model, d_ff, bias=False, kernel_init="lecun", **kw)
        self.wo = Dense(d_ff, d_model, bias=False, kernel_init="lecun", **kw)

    def forward(self, x, position_bias):
        x = x + self.attn(self.attn_norm(x), position_bias)
        return x + self.wo(torch.relu(self.wi(self.mlp_norm(x))))


class T5EncoderStack(nn.Module):
    def __init__(self, vocab_size: int = 32128, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12, d_kv: int = 64,
                 d_ff: int = 3072, rel_pos_buckets: int = 32,
                 rel_pos_max_distance: int = 128, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.rel_pos_buckets = rel_pos_buckets
        self.rel_pos_max_distance = rel_pos_max_distance
        self._buckets = {}      # (T, device) -> (T, T) int64 bucket ids
        self.token_embedding = Embed(vocab_size, d_model, std=1.0, **kw)
        self.relative_attention_bias = Embed(rel_pos_buckets, num_heads, **kw)
        self.blocks = nn.ModuleList(
            T5Block(d_model, num_heads, d_kv, d_ff, **kw)
            for _ in range(num_layers))
        self.final_norm = T5RMSNorm(d_model, **kw)

    def position_bias(self, t: int, device) -> torch.Tensor:
        """(H, T, T) float32 bias from the static bucket table (its device
        copy made once for each (T, device), so that a call copies nothing
        from the host: a CUDA graph could not capture that)."""
        key = (t, str(device))
        if key not in self._buckets:
            pos = np.arange(t)
            buckets = relative_position_bucket(
                pos[None, :] - pos[:, None], num_buckets=self.rel_pos_buckets,
                max_distance=self.rel_pos_max_distance)
            with torch.inference_mode(False):
                self._buckets[key] = torch.as_tensor(buckets, device=device)
        table = self.relative_attention_bias(self._buckets[key])  # (T, T, H)
        return table.permute(2, 0, 1).float()

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(token_ids)
        bias = self.position_bias(token_ids.shape[1], token_ids.device)
        for block in self.blocks:
            x = block(x, bias)
        return self.final_norm(x)
