"""Ahead-of-time policy export: the obs -> action function as a serialized
``torch.export`` program, so that a serving process loads it instead of
tracing the model.

Counterpart of the JAX package's ``serve/export.py`` (``jax.export``).  The
programs are exported non-strict and saved with ``torch.export.save``.

* The parameters are call-time inputs (``torch.func.functional_call``), as
  the JAX variables are: one artifact serves any checkpoint of the same
  structure, and the artifact holds no weights (the model's buffers, its
  static tables, are constants in it).
* A ``torch.Generator`` cannot be exported, so the diffusion head's draws
  are inputs too (the JAX artifact takes a PRNG key instead): the initial
  sample ``noisy`` (B, A) and, for DDPM with independent per-step noise,
  ``noise`` (T, B, A); :func:`draw_shapes` names them in order.
  ``PolicyEngine.load_artifact`` draws them from its generator, in the
  order the head would, so the artifact's actions equal the eager call's.
* The kernels are ``torch.library`` custom ops (``tokenmerge::ddpm_sampler``,
  ``tokenmerge::flash_fwd``, ``tokenmerge::group_norm_gelu``), which the
  exported graph names; loading imports this package, which registers
  them.  There is no fallback: an op that fails to build or launch raises.
* Every table the forward makes lazily (flash masks, DDPM coefficients,
  position and bucket tables) is made by one eager call before the export,
  on the model's device.  Artifacts are device-specific.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

import torch
from torch import nn

# importing the kernels' modules registers their custom ops
from ..ops import ddpm_sampler as _sampler_ops  # noqa: F401
from ..ops import flash_attention as _flash_ops  # noqa: F401
from ..ops import group_norm as _group_norm_ops  # noqa: F401

__all__ = ["export_policy", "export_cached_policy", "load_policy",
           "draw_shapes", "parameters_of", "PREDICT_METHODS",
           "CACHED_PREDICT_METHODS"]

PREDICT_METHODS = {
    "continuous": "predict_continuous_action",
    "categorical": "predict_action_logits",
    "diffusion": "predict_diffusion_action",
}

# cached-instruction variants: text arrives as (B, T, E) tower embeddings
CACHED_PREDICT_METHODS = {
    "continuous": "predict_continuous_action_with_text",
    "categorical": "predict_action_logits_with_text",
    "diffusion": "predict_diffusion_action_with_text",
}


def draw_shapes(model, head: str,
                batch_size: int) -> Dict[str, Tuple[int, ...]]:
    """The random inputs of an exported ``head`` program, in call order:
    none but for the diffusion head, which takes ``noisy`` (B, A) and, for
    DDPM unless ``sampler_rng_mode='reference'`` (which reuses ``noisy``),
    ``noise`` (T, B, A)."""
    if head != "diffusion":
        return {}
    cfg = model.config.heads.diffusion
    out = {"noisy": (batch_size, cfg.action_space_dim)}
    if cfg.ddim_steps is None and cfg.sampler_rng_mode != "reference":
        out["noise"] = (cfg.diffusion_steps, batch_size,
                        cfg.action_space_dim)
    return out


class _Method(nn.Module):
    """``forward`` = one predict method of the model (the module that
    ``functional_call`` re-parameterizes)."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, text, images, *draws):
        kw = dict(zip(("noisy", "noise"), draws))
        return getattr(self.model, self.method)(text, images, **kw)


class _Program(nn.Module):
    """The exported function ``(params, text, images, *draws) -> action``.
    The model is held outside the module tree, so its parameters enter
    only as the ``params`` input."""

    def __init__(self, model, method: str):
        super().__init__()
        self.__dict__["_method"] = _Method(model, method)

    def forward(self, params, text, images, *draws):
        return torch.func.functional_call(
            self._method, {f"model.{k}": v for k, v in params.items()},
            (text, images, *draws))


def parameters_of(model) -> Dict[str, torch.Tensor]:
    """The ``params`` input of an exported program: the model's parameters
    by name, detached."""
    return {k: v.detach() for k, v in model.named_parameters()}


def _export(model, head, methods, text, images, path):
    if head not in methods:
        raise ValueError(f"unknown head {head!r}; one of {sorted(methods)}")
    if getattr(model.config.heads, head) is None:
        raise ValueError(f"model has no {head!r} head configured")
    model = model.eval()
    device = model.device
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    draws = tuple(torch.randn(shape, generator=generator, device=device)
                  for shape in draw_shapes(model, head,
                                           images.shape[0]).values())
    program = _Program(model, methods[head])
    params = parameters_of(model)
    with torch.no_grad():
        program(params, text, images, *draws)   # makes the lazy tables
        exported = torch.export.export(
            program, (params, text, images, *draws), strict=False)
    # the example inputs hold the parameters: the artifact keeps no weights
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_policy(model, head: str, batch_size: int, text_shape,
                  image_shape, path: Optional[str] = None) -> bytes:
    """Export ``(params, text_tokens, images, *draws) -> action`` of the
    full path ((batch, *text_shape) int64 ids, (batch, *image_shape)
    float32 images) on the model's device.  Returns the artifact's bytes
    (also written to ``path`` when given)."""
    device = model.device
    text = torch.zeros((batch_size, *text_shape), dtype=torch.long,
                       device=device)
    images = torch.zeros((batch_size, *image_shape), device=device)
    return _export(model, head, PREDICT_METHODS, text, images, path)


def export_cached_policy(model, head: str, batch_size: int, text_shape,
                         image_shape, path: Optional[str] = None) -> bytes:
    """Export the cached-instruction path ``(params, text_embeddings,
    images, *draws) -> action``; ``text_embeddings`` is (batch,
    *text_shape, token_embedding_dim) in the compute dtype, what
    ``encode_text`` gives."""
    cfg = model.config
    device = model.device
    text = torch.zeros((batch_size, *text_shape, cfg.token_embedding_dim),
                       dtype=cfg.compute_dtype, device=device)
    images = torch.zeros((batch_size, *image_shape), device=device)
    return _export(model, head, CACHED_PREDICT_METHODS, text, images, path)


def load_policy(blob_or_path):
    """Load an exported artifact (bytes or a path); returns
    ``fn(params, text, images, *draws) -> action``."""
    if isinstance(blob_or_path, str):
        with open(blob_or_path, "rb") as f:
            blob_or_path = f.read()
    program = torch.export.load(io.BytesIO(blob_or_path)).module()

    def fn(params, text, images, *draws):
        with torch.no_grad():
            return program(params, text, images, *draws)

    return fn
