"""Weights carried across: a flax parameter tree -> the port's state_dict.

``from_flax(params, cfg)`` takes the JAX package's Octo parameter tree as
nested dicts of numpy arrays (with or without the outer ``'params'``) and
returns a ``state_dict`` for ``models.octo.Octo(cfg)``.  Layouts:

* ``nn.Dense`` kernels (in, out) -> ``weight`` (out, in);
* attention ``DenseGeneral`` q/k/v kernels (E, H, D) and biases (H, D) ->
  (H*D, E) and (H*D,); output kernels (H, D, E) -> (E, H*D); the T5 ``qkv``
  kernel (E, 3, H, D) -> (3*H*D, E);
* conv kernels HWIO -> OIHW;
* ``nn.scan``-stacked blocks (:func:`scanned_stacks`: the T5 tower's
  ``blocks``, and the transformer's ``blocks`` or, in the staged ToMe
  stack, every ``stage_{i}``) split along their leading layer axis; the
  per-layer ToMe blocks ``transformer/block_{l}`` are not stacked, and hold
  ``query`` / ``key`` / ``value`` / ``out`` directly;
* ``output_dense``'s rows are in flattened (h, w, c) order; the port
  flattens NCHW maps as (c, h, w), so the rows are permuted;
* ``scale`` and ``embedding`` -> ``weight``; everything else is copied,
  the MoE blocks' ``expert_wi/bi/wo/bo`` among them (stacked (E, ...) in
  both), and their ``router`` kernel transposes like any dense.

Any key the port does not have, and any key the port needs but the
tree lacks, raises, as does a shape mismatch.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .core.config import OctoConfig

__all__ = ["from_flax", "from_flax_variables", "scanned_stacks",
           "tree_to_state", "flax_layout"]


def scanned_stacks(cfg: OctoConfig) -> Tuple[Tuple[str, ...], ...]:
    """The block stacks the JAX package runs under ``nn.scan`` for this
    configuration: every flax leaf below one carries a leading layer axis."""
    from .sequence.layout import SequenceLayout
    stacks = [("text_encoder", "t5_encoder", "blocks")]
    tr = cfg.transformer
    layout = SequenceLayout.from_strings(cfg.input_sequence,
                                         cfg.compression_sequence)
    if not (layout.compressible and tr.compression_mode != "none"):
        stacks.append(("transformer", "blocks"))
    elif tr.tome_merge_every > 1:
        stages = -(-tr.num_blocks // tr.tome_merge_every)
        stacks += [("transformer", f"stage_{i}") for i in range(stages)]
    return tuple(stacks)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _kernel(module: str, k: np.ndarray, cfg: OctoConfig,
            parent: str = "resnet") -> np.ndarray:
    if module in ("query", "key", "value", "qkv"):
        return k.reshape(k.shape[0], -1).T
    if module in ("out", "o"):
        return k.reshape(-1, k.shape[-1]).T
    if k.ndim == 4:                                   # conv, HWIO
        return k.transpose(3, 2, 0, 1)
    if module == "output_dense" and parent == "resnet":
        c = cfg.images.resnet.features
        side = math.isqrt(k.shape[0] // c)
        if side * side * c != k.shape[0]:
            raise ValueError(f"output_dense kernel rows {k.shape[0]} are not "
                             f"a square map of {c} channels")
        k = k.reshape(side, side, c, -1).transpose(2, 0, 1, 3)
        return k.reshape(side * side * c, -1).T
    if k.ndim == 2:
        return k.T
    raise ValueError(f"unexpected {k.ndim}-D kernel under {module!r}")


def flax_layout(module: str, leaf: str, shape: Tuple[int, ...],
                kind: str = "", heads: Optional[int] = None):
    """The flax leaf name and shape of a port parameter, and for each flax
    axis the port axis that holds it (split axes merge into one): the
    inverse of :func:`_kernel` and :func:`_leaf`, which ``parallel.mesh``
    uses to apply the JAX sharding rules to the port's parameters.
    ``kind`` is what holds the parameter: ``'dense'`` (a (out, in) weight),
    ``'conv'``, ``'embed'``, ``'norm'`` or ``''`` (copied as it is);
    ``heads`` the head count of an attention projection."""
    shape = tuple(shape)
    if kind == "dense" and leaf == "weight":
        if module in ("query", "key", "value") and heads:
            hd, e = shape
            return "kernel", (e, heads, hd // heads), (1, 0, 0)
        if module == "qkv" and heads:
            hd3, e = shape
            return "kernel", (e, 3, heads, hd3 // (3 * heads)), (1, 0, 0, 0)
        if module in ("out", "o") and heads:
            e, hd = shape
            return "kernel", (heads, hd // heads, e), (1, 1, 0)
        return "kernel", (shape[1], shape[0]), (1, 0)
    if kind == "dense" and leaf == "bias" and module in (
            "query", "key", "value") and heads:
        return "bias", (heads, shape[0] // heads), (0, 0)
    if kind == "conv" and leaf == "weight":           # OIHW <- HWIO
        o, i, h, w = shape
        return "kernel", (h, w, i, o), (2, 3, 1, 0)
    if kind == "embed" and leaf == "weight":
        return "embedding", shape, tuple(range(len(shape)))
    if kind == "norm" and leaf == "weight":
        return "scale", shape, tuple(range(len(shape)))
    return leaf, shape, tuple(range(len(shape)))


def _leaf(path: Tuple[str, ...], arr: np.ndarray, cfg: OctoConfig):
    *mods, leaf = path
    module = mods[-1] if mods else ""
    if leaf == "kernel":
        parent = mods[-2] if len(mods) > 1 else ""
        return mods + ["weight"], _kernel(module, arr, cfg, parent)
    if leaf == "bias" and module in ("query", "key", "value"):
        return mods + ["bias"], arr.reshape(-1)
    if leaf in ("scale", "embedding"):
        return mods + ["weight"], arr
    return mods + [leaf], arr


def tree_to_state(params: Mapping, stacks: Tuple[Tuple[str, ...], ...] = (),
                  cfg: Optional[OctoConfig] = None
                  ) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts of arrays) -> float32 CPU
    tensors under the port's names, with the layouts above; the leaves
    under each path of ``stacks`` carry a leading layer axis and split
    along it.  ``cfg`` is needed only for an ``output_dense`` kernel."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, arr):
        names, value = _leaf(path, arr, cfg)
        out[".".join(names)] = torch.tensor(
            np.ascontiguousarray(value, dtype=np.float32))

    for path, arr in _flatten(params):
        for scanned in stacks:
            n = len(scanned)
            if path[:n] == scanned:
                for i in range(arr.shape[0]):
                    put(scanned + (str(i),) + path[n:], arr[i])
                break
        else:
            put(path, arr)
    return out


def from_flax(params: Mapping, cfg: OctoConfig) -> Dict[str, torch.Tensor]:
    """Flax Octo params (numpy) -> ``Octo(cfg).state_dict()``-shaped dict
    of CPU tensors, each in its port parameter's dtype (``cfg.params_dtype``;
    the MoE router float32, as in flax)."""
    from .models.octo import Octo

    if set(params) == {"params"}:
        params = params["params"]
    out = tree_to_state(params, scanned_stacks(cfg), cfg)
    expected = Octo(cfg, device="meta", seed=None).state_dict()
    unknown = sorted(set(out) - set(expected))
    missing = sorted(set(expected) - set(out))
    if unknown or missing:
        raise KeyError(f"flax tree does not match the port: unknown "
                       f"{unknown}, missing {missing}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: converted shape {tuple(v.shape)}, port "
                             f"expects {tuple(expected[k].shape)}")
        out[k] = v.to(expected[k].dtype)
    return out


def from_flax_variables(variables: Mapping, model: torch.nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """A flax variables dict (``{'params': ..., 'batch_stats': ...}``) of a
    model without scanned stacks (the legacy families of
    ``models.legacy``) -> ``model.state_dict()``-shaped dict, each in the
    dtype of the port's tensor.  ``batch_stats`` carry flax's
    ``mean`` and ``var`` (the biased batch variance, updated with flax's
    momentum) into the port's ``modules.layers.BatchNorm`` buffers of the
    same names, unchanged.  Layouts as :func:`tree_to_state`; the model's
    ``config`` sizes an image tower's ``output_dense``."""
    out: Dict[str, torch.Tensor] = {}
    cfg = getattr(model, "config", None)
    for collection in ("params", "batch_stats"):
        if collection in variables:
            out.update(tree_to_state(variables[collection], (), cfg))
    expected = model.state_dict()
    unknown = sorted(set(out) - set(expected))
    missing = sorted(set(expected) - set(out))
    if unknown or missing:
        raise KeyError(f"flax tree does not match the port: unknown "
                       f"{unknown}, missing {missing}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: converted shape {tuple(v.shape)}, port "
                             f"expects {tuple(expected[k].shape)}")
        out[k] = v.to(expected[k].dtype)
    return out
