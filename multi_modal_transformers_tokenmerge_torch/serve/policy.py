"""Policy inference engine with instruction caching and compiled
predict paths.

Counterpart of the JAX package's ``serve/policy.py:PolicyEngine`` for the
diffusion, continuous and categorical heads.  ``set_instruction`` runs the
frozen text tower once and keeps its embeddings, so each request runs only
the image tower, the transformer and the head; ``encode_instruction``
memoizes single instructions in a bounded LRU for mixed-instruction
batches.  String instructions go through ``tokenizer`` (e.g.
``modules.text.WordTokenizer`` or ``utils.spm.T5StyleTokenizer``).  The
diffusion head's action noise comes from one ``torch.Generator`` per
engine, on the model's device.

:meth:`PolicyEngine.compile` is the counterpart of the JAX engine's
ahead-of-time compilation: it makes a serving copy of the model whose
compute-dtype parameters are stored in that dtype (no cast per request)
and, on the card, captures the full path (token ids) and the cached path
(text embeddings) as CUDA graphs at the engine's batch size.  Meshes,
int8/w8 towers and export come with later parts of the port.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.octo import Octo
from ..utils.debug import jit_enabled

__all__ = ["PolicyEngine", "serving_copy"]

# head -> the model's predict method on cached text embeddings
_CACHED_METHODS = {
    "continuous": "predict_continuous_action_with_text",
    "categorical": "predict_action_logits_with_text",
    "diffusion": "predict_diffusion_action_with_text",
}


def serving_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` in which every parameter that its forward casts
    to the compute dtype before use (those a module names in
    ``CAST_PARAMS``) is stored in that dtype.  Its outputs equal the
    model's bit for bit: each cast is made once here instead of at every
    call.  Parameters used in float32 (the norms') stay as they are.  The
    copy is in eval mode and takes no gradient."""
    out = copy.deepcopy(model).eval().requires_grad_(False)
    with torch.no_grad():
        for m in out.modules():
            for name in getattr(m, "CAST_PARAMS", ()):
                p = getattr(m, name, None)
                if p is not None and p.dtype != m.dtype:
                    setattr(m, name, nn.Parameter(p.to(m.dtype),
                                                  requires_grad=False))
    return out


class PolicyEngine:
    """Batched obs -> action serving for an :class:`Octo` model."""

    def __init__(self, model: Octo, head: str = "diffusion",
                 batch_size: int = 1, seed: int = 0, cache_text: bool = True,
                 tokenizer=None, ddim_steps: Optional[int] = None):
        """``tokenizer``: optional callable mapping a list of strings to
        (B, T) int ids.  ``ddim_steps``: serve with S-step deterministic
        DDIM instead of the full DDPM reverse loop.  ``cache_text``:
        :meth:`compile` also compiles the cached-instruction path."""
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
        self.cache_text = cache_text
        self.tokenizer = tokenizer
        self.ddim_steps = ddim_steps
        self.device = model.device
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._text_embeddings: Optional[torch.Tensor] = None
        self._instruction_cache: "OrderedDict[tuple, torch.Tensor]" = \
            OrderedDict()
        self._instruction_cache_max = 512
        # set by compile(): the serving copy, and per path its graph
        self._serve_model: Optional[nn.Module] = None
        self._graphs = {}
        self._stream = None

    # -- instruction caching ---------------------------------------------

    def _tokenize(self, text) -> np.ndarray:
        """Ids of ``text``: a string is broadcast to the batch, a list of
        strings must hold one per row (the JAX engine's ``_tokenize``);
        ids pass through."""
        if isinstance(text, str) or (
                isinstance(text, (list, tuple)) and text
                and isinstance(text[0], str)):
            if self.tokenizer is None:
                raise ValueError(
                    "string instruction given but no tokenizer configured; "
                    "pass tokenizer= (e.g. utils.spm.T5StyleTokenizer) or "
                    "pre-tokenized ids")
            if isinstance(text, str):
                text = [text] * self.batch_size
            if len(text) != self.batch_size:
                raise ValueError(
                    f"got {len(text)} instruction strings for batch_size "
                    f"{self.batch_size}; pass one string (broadcast) or "
                    f"exactly batch_size strings")
            return np.asarray(self.tokenizer(list(text)))
        if isinstance(text, torch.Tensor):
            text = text.cpu().numpy()
        return np.asarray(text)

    def _batch_ids(self, text) -> np.ndarray:
        """(batch_size, T) ids: (T,) or (1, T) broadcast to the batch."""
        ids = self._tokenize(text)
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
        return ids

    @property
    def _model(self) -> nn.Module:
        return self._serve_model if self._serve_model is not None \
            else self.model

    def _encode(self, ids: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return self._model.encode_text(torch.tensor(
                np.ascontiguousarray(ids), dtype=torch.long,
                device=self.device))

    def set_instruction(self, text) -> "PolicyEngine":
        """Encode and cache one instruction for the whole batch (a string,
        (T,) or (1, T) ids, broadcast) or one per row (batch_size strings
        or (batch_size, T) ids)."""
        self._text_embeddings = self._encode(self._batch_ids(text))
        return self

    def encode_instruction(self, text) -> torch.Tensor:
        """ONE instruction -> (T, E) embeddings, memoized (bounded LRU).
        Rows can be stacked into ``text_embeddings=`` of a mixed batch."""
        if isinstance(text, str):
            if self.tokenizer is None:
                raise ValueError(
                    "string instruction given but no tokenizer configured")
            ids = np.asarray(self.tokenizer([text]))
        else:
            ids = self._tokenize(text)
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

    # -- compilation -------------------------------------------------------

    def compile(self, text_shape, image_shape,
                warmup: bool = True) -> "PolicyEngine":
        """Compile the predict paths for fixed input shapes.

        Makes the serving copy of the model (:func:`serving_copy`) once.
        On the card it then captures two CUDA graphs at the engine's batch
        size: the full path ((batch, *text_shape) ids and images) and, with
        ``cache_text``, the cached path ((batch, *text_shape, E) text
        embeddings and images).  Each is run once eagerly on a side stream
        first (kernel libraries, flash tables and schedules are made there,
        never during capture).  ``__call__`` then copies its inputs into a
        graph's buffers, replays it and returns a copy of its output.  The
        diffusion head draws its noise inside the graph from the engine's
        generator, which is registered with the graph, so a replay draws
        what the eager call would.  A capture that fails raises.

        An engine on the CPU makes the serving copy and, with ``warmup``,
        runs each path once on zeros, but captures nothing; so does an
        engine on the card while ``utils.debug`` runs the compiled paths
        eagerly (``disable_jit`` or NaN checks), and a call made in that
        mode runs eagerly even where graphs were captured.  Neither the
        warm-up nor the capture consumes the engine's noise stream."""
        self._serve_model = serving_copy(self.model)
        self._graphs = {}
        b = self.batch_size
        text_shape, image_shape = tuple(text_shape), tuple(image_shape)
        images = torch.zeros((b, *image_shape), device=self.device)
        paths = [("full", torch.zeros((b, *text_shape), dtype=torch.long,
                                      device=self.device))]
        if self.cache_text:
            cfg = self.model.config
            paths.append(("cached", torch.zeros(
                (b, *text_shape, cfg.token_embedding_dim),
                dtype=cfg.compute_dtype, device=self.device)))
        saved = self._generator.get_state()
        capture = self.device.type == "cuda" and jit_enabled()
        for path, text in paths:
            if capture:
                self._capture(path, text, images)
            elif warmup:
                self._predict(path, text, images, None, None)
        if capture and warmup:
            for path, text in paths:
                self._replay(path, text, images)
            torch.cuda.synchronize(self.device)
        self._generator.set_state(saved)
        return self

    def _predict(self, path, text, images, noisy, noise):
        model = self._model
        with torch.inference_mode():
            emb = model.encode_text(text) if path == "full" else text
            predict = getattr(model, _CACHED_METHODS[self.head])
            if self.head != "diffusion":
                return predict(emb, images)
            return predict(emb, images, noisy=noisy, noise=noise,
                           generator=self._generator,
                           ddim_steps=self.ddim_steps)

    def _capture(self, path, text, images):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        static = (text.clone(), images.clone())
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._predict(path, *static, None, None)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        with torch.cuda.graph(graph, stream=stream):
            out = self._predict(path, *static, None, None)
        self._graphs[path] = (graph, static, out)

    def _replay(self, path, text, images):
        graph, (s_text, s_images), out = self._graphs[path]
        if tuple(text.shape) != tuple(s_text.shape) or \
                tuple(images.shape) != tuple(s_images.shape):
            raise ValueError(
                f"the {path} path was compiled for text {tuple(s_text.shape)}"
                f" and images {tuple(s_images.shape)}; got "
                f"{tuple(text.shape)} and {tuple(images.shape)}")
        s_text.copy_(text)
        s_images.copy_(images)
        graph.replay()
        return out.clone()

    # -- serving -----------------------------------------------------------

    def __call__(self, images, text_tokens=None, text_embeddings=None, *,
                 noisy: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One obs -> action inference: (B, [F,] H, W, C) images ->
        (B, A) float32 actions (diffusion), (B, 1, A) actions (continuous)
        or (B, A, num_bins) logits (categorical).

        The cached instruction serves unless ``text_tokens`` (a string,
        strings or ids, as :meth:`set_instruction` takes them) or
        ``text_embeddings`` (B, T, E) is given.  ``noisy`` and ``noise``
        replace the engine's own draws of the diffusion head (see
        ``DiffusionActionHead.predict_action``); a compiled engine then
        runs that call eagerly on its serving copy."""
        if text_tokens is not None and text_embeddings is not None:
            raise ValueError("pass text_tokens or text_embeddings, not both")
        images = torch.as_tensor(images, device=self.device)
        if images.shape[0] != self.batch_size:
            raise ValueError(f"got {images.shape[0]} images for batch_size "
                             f"{self.batch_size}")
        if text_tokens is not None:
            path = "full"
            text = torch.tensor(np.ascontiguousarray(
                self._batch_ids(text_tokens)), dtype=torch.long,
                device=self.device)
        else:
            path = "cached"
            text = (self._text_embeddings if text_embeddings is None
                    else torch.as_tensor(text_embeddings, device=self.device))
            if text is None:
                raise ValueError(
                    "no instruction set: call set_instruction(text_tokens) "
                    "or pass text_tokens / text_embeddings")
        if (path in self._graphs and noisy is None and noise is None
                and jit_enabled()):
            return self._replay(path, text, images)
        return self._predict(path, text, images, noisy, noise)
