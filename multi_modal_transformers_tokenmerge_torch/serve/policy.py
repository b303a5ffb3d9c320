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
(text embeddings) as CUDA graphs at the engine's batch size.

``image_tower`` and ``text_tower`` ('bf16', 'int8' or 'w8') put the
quantized towers of ``serve.quantize`` in place of the model's own: the
image tower on both request paths (through the model's
``*_with_modalities`` methods), the text tower wherever an instruction is
encoded (``set_instruction``, ``encode_instruction``), as the JAX engine
does.  :meth:`PolicyEngine.load_artifact` serves through programs exported
by ``serve.export`` instead of the model's own methods.

``mesh`` (``parallel.mesh.make_mesh``) serves data parallel, as the JAX
engine's mesh does: the parameters are replicated, every rank is handed
the global batch of ``batch_size`` rows, runs its rows of the ``data``
axis (eagerly, or through graphs captured at its share of the batch) and
all-gathers the result, so every rank returns the global actions.  The
diffusion head's draws are made for the global batch from the engine's
generator and cut to the rank's rows (``core.global_batch.
data_parallel``), so the actions equal an un-meshed engine's; at a data
size of one nothing is cut or gathered.

Tracing (``utils.profiling``; on only while a profiler session records).
Each call is one ``engine.call`` span, carrying the engine's call ordinal
in its arguments.  Under it a graph replay is ``engine.stage_in`` (the
frames to the card, the row cut, the copies into the graph's buffers),
``engine.launch`` (``graph.replay()`` alone) and ``engine.stage_out`` (the
copy of the output, the gather); an eager or artifact call is
``engine.eager`` instead.  :meth:`PolicyEngine.compile` is
``engine.compile``, with ``engine.serving_copy``, one ``engine.capture``
per path (its eager run and its capture) and ``engine.compile_replay``
under it.  Set-up never falls inside a benchmark's traced window, so no
metric reads the compile spans: they show the operator who traces
``compile()`` with ``utils.profiling.trace`` where set-up goes.  Each
capture records its graph's node plan (``utils.profiling.node_plan``);
``REGISTRY.counters`` counts calls by route (``engine.replays``,
``engine.eager_calls``).
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.octo import Octo
from ..core.global_batch import data_parallel, draw_global
from ..parallel.mesh import DATA_AXIS, data_info
from ..utils.debug import jit_enabled
from ..utils.profiling import (REGISTRY, capture_counter, node_plan, section,
                               span)
from .export import (CACHED_PREDICT_METHODS as _CACHED_METHODS, draw_shapes,
                     load_policy, parameters_of)
from .quantize import (image_embed_int8, image_embed_w8, quantize_image_tower,
                       quantize_t5_params, t5_encode_int8)

__all__ = ["PolicyEngine", "serving_copy", "TOWERS"]

TOWERS = ("bf16", "int8", "w8")


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
                 tokenizer=None, ddim_steps: Optional[int] = None,
                 image_tower: str = "bf16", text_tower: str = "bf16",
                 mesh=None):
        """``tokenizer``: optional callable mapping a list of strings to
        (B, T) int ids.  ``ddim_steps``: serve with S-step deterministic
        DDIM instead of the full DDPM reverse loop.  ``cache_text``:
        :meth:`compile` also compiles the cached-instruction path.
        ``image_tower``: 'bf16' (the model's own), 'int8' (int8 weights and
        activations, int32 sums) or 'w8' (int8-stored weights, float
        compute).  ``text_tower``: the same three for the T5 tower that
        encodes instructions; a quantized one needs a 't5' text encoder.
        ``mesh``: data-parallel serving (see the module docstring);
        ``batch_size`` is the global batch and must divide by the data
        axis."""
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
        for name, tower in (("image_tower", image_tower),
                            ("text_tower", text_tower)):
            if tower not in TOWERS:
                raise ValueError(f"unknown {name} {tower!r}; 'bf16', "
                                 f"'int8' or 'w8'")
        if text_tower != "bf16" and model.config.text.kind != "t5":
            raise ValueError(
                f"text_tower={text_tower!r} requires a t5 text encoder, got "
                f"{model.config.text.kind!r}")
        self.mesh = mesh
        self._data_rank, self._data_size = data_info(mesh)
        if batch_size % self._data_size:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh data "
                f"axis ({self._data_size})")
        self._local_batch = batch_size // self._data_size
        self._group = mesh.get_group(DATA_AXIS) if mesh is not None else None
        self.model = model.eval().requires_grad_(False)
        self.image_tower = image_tower
        self.text_tower = text_tower
        self._image_qp = (quantize_image_tower(model)
                          if image_tower != "bf16" else None)
        self._text_qp = (quantize_t5_params(model.text_encoder.t5_encoder)
                         if text_tower != "bf16" else None)
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
        # set by load_artifact(): path -> loaded program
        self._artifacts = {}
        self._calls = 0

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
        ids = torch.tensor(np.ascontiguousarray(ids), dtype=torch.long,
                           device=self.device)
        with torch.inference_mode():
            if self._text_qp is None:
                return self._model.encode_text(ids)
            cfg = self.model.config
            return t5_encode_int8(
                self._text_qp, ids,
                rel_pos_buckets=cfg.text.t5_rel_pos_buckets,
                rel_pos_max_distance=cfg.text.t5_rel_pos_max_distance,
                dtype=cfg.compute_dtype, mode=self.text_tower)

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

    # -- exported programs -------------------------------------------------

    def load_artifact(self, blob_or_path,
                      cached_blob_or_path=None) -> "PolicyEngine":
        """Serve through exported programs (``serve.export``): the full
        path from ``blob_or_path`` (``export_policy``) and, when given, the
        cached-instruction path from ``cached_blob_or_path``
        (``export_cached_policy``); a path without one runs as before.
        Each call hands the program the model's parameters and, for the
        diffusion head, draws from the engine's generator in the order the
        head draws them, so it returns what the eager call would.  The
        artifacts serve the model's own image tower, as in the JAX engine,
        and the sampler they were exported with (no ``ddim_steps``)."""
        if self.image_tower != "bf16":
            raise ValueError(
                "exported policy artifacts serve the model's own (bf16) "
                "image tower; build an image_tower='bf16' engine or "
                f"compile() the {self.image_tower} engine in-process")
        if self.ddim_steps is not None:
            raise ValueError("an exported artifact runs the sampler it was "
                             "exported with; build the engine without "
                             "ddim_steps")
        self._artifacts = {"full": load_policy(blob_or_path)}
        if cached_blob_or_path is not None:
            self._artifacts["cached"] = load_policy(cached_blob_or_path)
        self._artifact_params = parameters_of(self.model)
        return self

    def _run_artifact(self, path, text, images, noisy, noise):
        given = {"noisy": noisy, "noise": noise}
        with data_parallel(self._group):
            draws = [given[name].to(self.device, torch.float32)
                     if given[name] is not None else
                     draw_global(lambda s: torch.randn(
                         s, generator=self._generator, device=self.device),
                         shape, dim=1 if name == "noise" else 0)
                     for name, shape in draw_shapes(
                         self.model, self.head, images.shape[0]).items()]
        return self._artifacts[path](self._artifact_params, text,
                                     images.to(torch.float32), *draws)

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
        with span("engine.compile"):
            return self._compile(text_shape, image_shape, warmup)

    def _compile(self, text_shape, image_shape, warmup):
        with span("engine.serving_copy"):
            self._serve_model = serving_copy(self.model)
        self._graphs = {}
        b = self._local_batch
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
                with span("engine.capture", path):
                    self._capture(path, text, images)
            elif warmup:
                self._predict(path, text, images, None, None)
        if capture and warmup:
            with span("engine.compile_replay"):
                for path, text in paths:
                    self._stage(path, text, images)[0].replay()
                torch.cuda.synchronize(self.device)
        self._generator.set_state(saved)
        return self

    def _rows(self, x: torch.Tensor, name: str = "") -> torch.Tensor:
        """This rank's rows of a global batch tensor (the per-step
        ``noise`` (T, B, A) along its second axis)."""
        if self._data_size == 1:
            return x
        dim = 1 if name == "noise" else 0
        n = self._local_batch
        return x.narrow(dim, self._data_rank * n, n)

    def _gather(self, out: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order (``out`` at a data size of
        one)."""
        if self._data_size == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(self._data_size)]
        dist.all_gather(parts, out.contiguous(), group=self._group)
        return torch.cat(parts)

    def _predict(self, path, text, images, noisy, noise):
        model = self._model
        with torch.inference_mode(), data_parallel(self._group):
            emb = model.encode_text(text) if path == "full" else text
            sample_kw = dict(noisy=noisy, noise=noise,
                             generator=self._generator,
                             ddim_steps=self.ddim_steps)
            if self._image_qp is not None:
                return self._predict_quantized(model, emb, images, sample_kw)
            predict = getattr(model, _CACHED_METHODS[self.head])
            if self.head != "diffusion":
                return predict(emb, images)
            return predict(emb, images, **sample_kw)

    def _predict_quantized(self, model, text_embeddings, images, sample_kw):
        """Text embeddings + images -> actions through the quantized image
        tower and the model's ``*_with_modalities`` path."""
        cfg = self.model.config
        embed = image_embed_w8 if self.image_tower == "w8" \
            else image_embed_int8
        with section("model.image"):
            image_embeddings = embed(self._image_qp, images, cfg.images,
                                     dtype=cfg.compute_dtype)
        if self.head == "diffusion":
            return model.predict_diffusion_action_with_modalities(
                text_embeddings, image_embeddings, **sample_kw)
        readouts = model.generate_readouts_with_modalities(
            text_embeddings, image_embeddings)
        if self.head == "continuous":
            return model.continuous_action_head(readouts)
        return model.categorical_action_head(readouts)

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
        count = capture_counter(stream)
        with torch.cuda.graph(graph, stream=stream):
            with node_plan(path, count):
                out = self._predict(path, *static, None, None)
        self._graphs[path] = (graph, static, out)

    def _stage(self, path, text, images):
        """Copy the inputs into the ``path`` graph's buffers: (its graph,
        its output buffer)."""
        graph, (s_text, s_images), out = self._graphs[path]
        if tuple(text.shape) != tuple(s_text.shape) or \
                tuple(images.shape) != tuple(s_images.shape):
            raise ValueError(
                f"the {path} path was compiled for text {tuple(s_text.shape)}"
                f" and images {tuple(s_images.shape)}; got "
                f"{tuple(text.shape)} and {tuple(images.shape)}")
        s_text.copy_(text)
        s_images.copy_(images)
        return graph, out

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
        runs that call eagerly on its serving copy, an engine with a
        loaded artifact hands them to the program."""
        if text_tokens is not None and text_embeddings is not None:
            raise ValueError("pass text_tokens or text_embeddings, not both")
        path = "full" if text_tokens is not None else "cached"
        replay = (path not in self._artifacts and path in self._graphs
                  and noisy is None and noise is None and jit_enabled())
        REGISTRY.counters["engine.replays" if replay
                          else "engine.eager_calls"] += 1
        self._calls += 1
        with span("engine.call", self._calls):
            if replay:
                with span("engine.stage_in"):
                    graph, out = self._stage(path, *self._inputs(
                        images, text_tokens, text_embeddings))
                with span("engine.launch"):
                    graph.replay()
                with span("engine.stage_out"):
                    return self._gather(out.clone())
            with span("engine.eager"):
                text, images = self._inputs(images, text_tokens,
                                            text_embeddings)
                if self._data_size > 1:
                    noisy = None if noisy is None else self._rows(
                        torch.as_tensor(noisy, device=self.device))
                    noise = None if noise is None else self._rows(
                        torch.as_tensor(noise, device=self.device), "noise")
                if path in self._artifacts:
                    out = self._run_artifact(path, text, images, noisy, noise)
                else:
                    out = self._predict(path, text, images, noisy, noise)
                return self._gather(out)

    def _inputs(self, images, text_tokens, text_embeddings):
        """(text, images) of a call on the engine's device, this rank's
        rows."""
        images = torch.as_tensor(images, device=self.device)
        if images.shape[0] != self.batch_size:
            raise ValueError(f"got {images.shape[0]} images for batch_size "
                             f"{self.batch_size}")
        if text_tokens is not None:
            text = torch.tensor(np.ascontiguousarray(
                self._batch_ids(text_tokens)), dtype=torch.long,
                device=self.device)
        else:
            text = (self._text_embeddings if text_embeddings is None
                    else torch.as_tensor(text_embeddings, device=self.device))
            if text is None:
                raise ValueError(
                    "no instruction set: call set_instruction(text_tokens) "
                    "or pass text_tokens / text_embeddings")
        if self._data_size > 1:
            text, images = self._rows(text), self._rows(images)
        return text, images
