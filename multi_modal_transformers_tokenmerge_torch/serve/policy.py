"""Policy inference engine with instruction caching.

Counterpart of the JAX package's ``serve/policy.py:PolicyEngine`` for the
diffusion, continuous and categorical heads.  ``set_instruction`` runs the
frozen text tower once and keeps its embeddings, so each request runs only
the image tower, the transformer and the head; ``encode_instruction``
memoizes single instructions in a bounded LRU for mixed-instruction
batches.  The diffusion head's action noise comes from one
``torch.Generator`` per engine, on the model's device.

Ahead-of-time compilation, meshes, int8/w8 towers and export come with
later parts of the port.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..models.octo import Octo

__all__ = ["PolicyEngine"]

# head -> the model's predict method on cached text embeddings
_CACHED_METHODS = {
    "continuous": "predict_continuous_action_with_text",
    "categorical": "predict_action_logits_with_text",
    "diffusion": "predict_diffusion_action_with_text",
}


class PolicyEngine:
    """Batched obs -> action serving for an :class:`Octo` model."""

    def __init__(self, model: Octo, head: str = "diffusion",
                 batch_size: int = 1, seed: int = 0, tokenizer=None,
                 ddim_steps: Optional[int] = None):
        """``tokenizer``: optional callable mapping a list of strings to
        (B, T) int ids.  ``ddim_steps``: serve with S-step deterministic
        DDIM instead of the full DDPM reverse loop."""
        if ddim_steps is not None and head != "diffusion":
            raise ValueError("ddim_steps only applies to the diffusion "
                             f"head, got head={head!r}")
        if head not in _CACHED_METHODS:
            raise ValueError(
                f"unknown head {head!r}; one of {sorted(_CACHED_METHODS)}")
        if getattr(model.config.heads, head) is None:
            available = [h for h in _CACHED_METHODS
                         if getattr(model.config.heads, h) is not None]
            raise ValueError(f"model has no {head!r} head configured; "
                             f"available: {available}")
        self.model = model.eval().requires_grad_(False)
        self.head = head
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.ddim_steps = ddim_steps
        self.device = model.device
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._text_embeddings: Optional[torch.Tensor] = None
        self._instruction_cache: "OrderedDict[tuple, torch.Tensor]" = \
            OrderedDict()
        self._instruction_cache_max = 512

    # -- instruction caching ---------------------------------------------

    def _ids(self, text) -> np.ndarray:
        if isinstance(text, str) or (
                isinstance(text, (list, tuple)) and text
                and isinstance(text[0], str)):
            if self.tokenizer is None:
                raise ValueError("string instruction given but no tokenizer "
                                 "configured; pass pre-tokenized ids")
            if isinstance(text, str):
                text = [text]
            return np.asarray(self.tokenizer(list(text)))
        if isinstance(text, torch.Tensor):
            text = text.cpu().numpy()
        return np.asarray(text)

    def _encode(self, ids: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return self.model.encode_text(torch.tensor(
                np.ascontiguousarray(ids), dtype=torch.long,
                device=self.device))

    def set_instruction(self, text) -> "PolicyEngine":
        """Encode and cache one instruction for the whole batch ((T,) or
        (1, T) ids, broadcast) or one per row ((batch_size, T))."""
        ids = self._ids(text)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.ndim != 2:
            raise ValueError(f"instruction ids must be (T,), (1, T) or "
                             f"(batch, T); got shape {ids.shape}")
        if ids.shape[0] == 1 and self.batch_size > 1:
            ids = np.broadcast_to(ids, (self.batch_size, ids.shape[1]))
        if ids.shape[0] != self.batch_size:
            raise ValueError(
                f"got {ids.shape[0]} instruction rows for batch_size "
                f"{self.batch_size}; pass one row or exactly batch_size rows")
        self._text_embeddings = self._encode(ids)
        return self

    def encode_instruction(self, text) -> torch.Tensor:
        """ONE instruction -> (T, E) embeddings, memoized (bounded LRU).
        Rows can be stacked into ``text_embeddings=`` of a mixed batch."""
        ids = self._ids(text)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise ValueError(f"encode_instruction takes ONE instruction, "
                             f"got batch {ids.shape[0]}")
        key = (ids.dtype.str, ids.shape, ids.tobytes())
        hit = self._instruction_cache.pop(key, None)
        if hit is None:
            hit = self._encode(ids)[0]
        self._instruction_cache[key] = hit
        while len(self._instruction_cache) > self._instruction_cache_max:
            self._instruction_cache.popitem(last=False)
        return hit

    # -- serving -----------------------------------------------------------

    def __call__(self, images, text_tokens=None, text_embeddings=None, *,
                 noisy: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One obs -> action inference: (B, [F,] H, W, C) images ->
        (B, A) float32 actions (diffusion), (B, 1, A) actions (continuous)
        or (B, A, num_bins) logits (categorical).

        The cached instruction serves unless ``text_tokens`` or
        ``text_embeddings`` (B, T, E) is given.  ``noisy`` and ``noise``
        replace the engine's own draws of the diffusion head (see
        ``DiffusionActionHead.predict_action``)."""
        if text_tokens is not None and text_embeddings is not None:
            raise ValueError("pass text_tokens or text_embeddings, not both")
        images = torch.as_tensor(images, device=self.device)
        if images.shape[0] != self.batch_size:
            raise ValueError(f"got {images.shape[0]} images for batch_size "
                             f"{self.batch_size}")
        if text_tokens is not None:
            ids = self._ids(text_tokens)
            if ids.ndim == 1:
                ids = ids[None]
            if ids.shape[0] == 1 and self.batch_size > 1:
                ids = np.broadcast_to(ids, (self.batch_size, ids.shape[1]))
            emb = self._encode(ids)
        elif text_embeddings is not None:
            emb = torch.as_tensor(text_embeddings, device=self.device)
        else:
            emb = self._text_embeddings
            if emb is None:
                raise ValueError(
                    "no instruction set: call set_instruction(text_tokens) "
                    "or pass text_tokens / text_embeddings")
        predict = getattr(self.model, _CACHED_METHODS[self.head])
        with torch.inference_mode():
            if self.head != "diffusion":
                return predict(emb, images)
            return predict(emb, images, noisy=noisy, noise=noise,
                           generator=self._generator,
                           ddim_steps=self.ddim_steps)
