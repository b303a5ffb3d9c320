"""Text encoders: learned embeddings (``kind='embed'``) or the frozen T5
tower (``kind='t5'``), and the whitespace ``WordTokenizer``.  Counterpart
of the JAX package's ``modules/text.py``."""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np
import torch
from torch import nn

from ..core.config import TextEncoderConfig
from .layers import Embed
from .t5 import T5EncoderStack

__all__ = ["EmbedTextEncoder", "FrozenT5TextEncoder", "build_text_encoder",
           "WordTokenizer"]


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


class WordTokenizer:
    """Whitespace word tokenizer with a fixed vocabulary (host-side).
    Index 0 is the pad token, 1 the unknown word."""

    PAD = 0
    UNK = 1

    def __init__(self, vocab: Iterable[str], max_length: int = 16):
        words = sorted(set(w.strip() for w in vocab if w.strip()))
        self.word2idx = {w: i + 2 for i, w in enumerate(words)}
        self.idx2word = {v: k for k, v in self.word2idx.items()}
        self.idx2word[self.PAD] = "<pad>"
        self.idx2word[self.UNK] = "<unk>"
        self.vocab_size = len(self.word2idx) + 2
        self.max_length = max_length

    @classmethod
    def from_corpus(cls, texts: Sequence[str], max_length: int = 16):
        vocab = set()
        for t in texts:
            vocab.update(t.lower().split())
        return cls(vocab, max_length=max_length)

    @classmethod
    def from_vocab_file(cls, path: str, max_length: int = 16):
        """Newline-separated vocabulary file."""
        with open(path) as f:
            return cls(f.read().split("\n"), max_length=max_length)

    def encode(self, text: str) -> List[int]:
        ids = [self.word2idx.get(w, self.UNK) for w in text.lower().split()]
        ids = ids[: self.max_length]
        ids += [self.PAD] * (self.max_length - len(ids))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(t) for t in texts], dtype=np.int32)
