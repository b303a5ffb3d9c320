"""Text encoders: learned embeddings (``kind='embed'``) or the frozen T5
tower (``kind='t5'``).  Counterpart of the JAX package's
``modules/text.py``."""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import TextEncoderConfig
from .layers import Embed
from .t5 import T5EncoderStack

__all__ = ["EmbedTextEncoder", "FrozenT5TextEncoder", "build_text_encoder"]


class EmbedTextEncoder(nn.Module):
    """Learned token embedding + learned absolute position embedding."""

    def __init__(self, cfg: TextEncoderConfig, **kw):
        super().__init__()
        self.token_embedding = Embed(cfg.vocab_size, cfg.embedding_dim, **kw)
        self.position_embedding = Embed(cfg.max_length, cfg.embedding_dim,
                                        **kw)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        t = token_ids.shape[1]
        pos = torch.arange(t, device=token_ids.device)
        return self.token_embedding(token_ids) + self.position_embedding(pos)


class FrozenT5TextEncoder(nn.Module):
    """The T5 stack; with ``cfg.frozen`` its output carries no gradient."""

    def __init__(self, cfg: TextEncoderConfig, **kw):
        super().__init__()
        self.frozen = cfg.frozen
        self.t5_encoder = T5EncoderStack(
            vocab_size=cfg.vocab_size, d_model=cfg.embedding_dim,
            num_layers=cfg.t5_num_layers, num_heads=cfg.t5_num_heads,
            d_kv=cfg.t5_d_kv, d_ff=cfg.t5_d_ff,
            rel_pos_buckets=cfg.t5_rel_pos_buckets,
            rel_pos_max_distance=cfg.t5_rel_pos_max_distance, **kw)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        if self.frozen:
            # no graph is recorded for a tower that gets no gradient
            with torch.no_grad():
                return self.t5_encoder(token_ids)
        return self.t5_encoder(token_ids)


def build_text_encoder(cfg: TextEncoderConfig, **kw) -> nn.Module:
    if cfg.kind == "embed":
        return EmbedTextEncoder(cfg, **kw)
    if cfg.kind == "t5":
        return FrozenT5TextEncoder(cfg, **kw)
    raise ValueError(f"unknown text encoder kind {cfg.kind!r}")
