"""Synthetic batches and the frozen text tower's embedding cache.

Counterpart of the JAX package's ``utils/data.py``
(``synthetic_octo_batches``, ``cache_text_embeddings``).
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["synthetic_octo_batches", "cache_text_embeddings"]


def synthetic_octo_batches(batch_size: int, image_shape=(2, 280, 280, 3),
                           text_length: int = 16, action_dim: int = 8,
                           vocab_size: int = 32128, seed: int = 0):
    """Endless synthetic (text_tokens, images, actions) numpy batches:
    int32 ids, uint8-valued float32 images, float32 actions in [-1, 1)."""
    rng = np.random.default_rng(seed)
    while True:
        yield (
            rng.integers(0, vocab_size, (batch_size, text_length),
                         dtype=np.int32),
            rng.integers(0, 256, (batch_size, *image_shape)).astype(
                np.float32),
            rng.uniform(-1, 1, (batch_size, action_dim)).astype(np.float32),
        )


def cache_text_embeddings(batch_iter: Iterable, model,
                          max_cache_rows: int = 1024) -> Iterator:
    """Map ``(text_ids, images, actions)`` batches to ``(text_embeddings,
    images, actions)``, running the frozen text tower once per distinct
    instruction row (an LRU of ``max_cache_rows`` rows on the model's
    device).  Exact, not approximate: the frozen tower's output per
    instruction is a constant.  A batch with any miss encodes the whole
    batch.  Pair with ``make_train_step(..., text_input='embeddings')``."""
    tcfg = model.config.text
    if not (tcfg.kind == "t5" and tcfg.frozen):
        raise ValueError(
            "cache_text_embeddings requires a frozen text tower "
            "(config.text.kind='t5' with frozen=True); got "
            f"kind={tcfg.kind!r}, frozen={tcfg.frozen!r}"
            " - a trainable tower's output changes every step")
    device = model.device

    def gen():
        cache: "collections.OrderedDict[bytes, torch.Tensor]" = \
            collections.OrderedDict()
        for ids, *rest in batch_iter:
            ids_np = np.asarray(ids)
            keys = [row.tobytes() for row in ids_np]
            if all(k in cache for k in keys):
                for k in keys:
                    cache.move_to_end(k)
                emb = torch.stack([cache[k] for k in keys])
            else:
                with torch.no_grad():
                    emb = model.encode_text(torch.as_tensor(ids_np,
                                                            device=device))
                for k, row in zip(keys, emb):
                    # a clone: a view would pin the whole batch
                    cache[k] = row.clone()
                    cache.move_to_end(k)
                while len(cache) > max_cache_rows:
                    cache.popitem(last=False)
            yield (emb, *rest)

    return gen()
