"""Optimizer construction: warmup-cosine schedule, global-norm clipping,
AdamW with masked weight decay, frozen-module masking.

Counterpart of the JAX package's ``train/optim.py``, which chains optax
transforms.  This module reproduces that chain's arithmetic, which differs
from torch's own optimizers in four places:

* the learning rate of update ``n`` (counted from 0) is ``schedule(n)``,
  and optax's warmup starts at 0, so the first update moves nothing when
  ``warmup_steps > 0``;
* clipping scales by ``max_norm / |g|`` only when ``|g| >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``|g| + 1e-6``);
* Adam's ``eps`` is added outside the square root of the bias-corrected
  second moment;
* weight decay follows the FLAX parameter tree: every leaf with flax
  ``ndim >= 2`` whose name is not ``embedding`` / ``pos_embedding``.  That
  includes the attention q/k/v biases, (H, D) in flax but 1-D here,
  ``fourier_kernel``, and every leaf of the scanned block stacks (the ToMe
  ``stage_{i}`` among them), whose layer axis makes their norms and biases
  2-D in flax.  A parameter without a gradient (the frozen T5 tower
  when nothing is masked) takes a zero gradient, so unmasked decay still
  shrinks it, as optax does.

The optimizer updates the parameters in place (no copy of the parameter
tree per step).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

__all__ = ["warmup_cosine_schedule", "make_optimizer", "decay_mask",
           "trainable_mask", "mask_frozen", "global_norm", "Optimizer"]


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           end_lr_ratio: float = 0.1) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    max(total_steps, warmup_steps + 1), peak_lr * end_lr_ratio)``: linear
    from 0 over the warmup, then cosine down to the end value."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    end_lr = peak_lr * end_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return -peak_lr * frac + peak_lr
        c = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies: the flax leaves
    of two or more dims other than embeddings and position embeddings.

    A q/k/v bias is an (H, D) leaf in flax.  The JAX package scans its
    block stacks (``convert.scanned_stacks`` of the model's configuration:
    the T5 tower, the transformer's ``blocks`` or the ToMe ``stage_{i}``),
    so every leaf there carries a leading layer axis: the layer norms'
    scales and every bias of a block count as 2-D and decay.  The per-layer
    ToMe blocks ``block_{l}`` are not scanned: their norms and plain biases
    are 1-D and do not decay."""
    from ..convert import scanned_stacks
    from ..modules.layers import Embed
    embeddings = {id(m.weight) for m in model.modules()
                  if isinstance(m, Embed)}
    scanned = tuple(".".join(s) + "." for s in scanned_stacks(model.config))
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if id(p) in embeddings or parts[-1] == "pos_embedding":
            out[name] = False
            continue
        head_bias = (parts[-1] == "bias" and len(parts) > 1
                     and parts[-2] in ("query", "key", "value"))
        flax_ndim = (2 if head_bias else p.ndim) + int(
            name.startswith(scanned))
        out[name] = flax_ndim >= 2
    return out


def trainable_mask(model: nn.Module,
                   frozen_prefixes: Sequence[str] = ("text_encoder",)
                   ) -> Dict[str, bool]:
    """Parameter name -> False under a frozen top-level module."""
    return {name: name.split(".")[0] not in frozen_prefixes
            for name, _ in model.named_parameters()}


class Optimizer:
    """The optax chain ``[masked](clip_by_global_norm, adamw(schedule, b1,
    b2, eps, weight_decay, mask))`` over named parameters.

    :meth:`init` creates the moments of the trainable parameters;
    :meth:`step` applies one update in place.  Frozen parameters carry no
    state and are never changed."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 clip_norm: Optional[float],
                 decay: Optional[Dict[str, bool]] = None,
                 trainable: Optional[Dict[str, bool]] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.decay = decay
        self.trainable = trainable
        self.count = 0
        self.names: List[str] = []
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, named_params: Iterable) -> None:
        params = dict(named_params)
        self.count = 0
        self.names = [n for n in params
                      if self.trainable is None or self.trainable[n]]
        self.mu = [torch.zeros_like(params[n]) for n in self.names]
        self.nu = [torch.zeros_like(params[n]) for n in self.names]

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One update of ``params`` (name -> tensor) from ``grads`` (name ->
        gradient, or None for none); the gradients may be scaled in place."""
        p = [params[n] for n in self.names]
        g = [grads.get(n) if grads.get(n) is not None
             else torch.zeros_like(params[n]) for n in self.names]
        if self.clip_norm is not None and g:
            norm = global_norm(g)
            scale = torch.where(norm < self.clip_norm, 1.0,
                                self.clip_norm / norm)
            torch._foreach_mul_(g, scale)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - b2)
        lr = self.schedule(self.count)
        self.count += 1
        m_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        v_hat = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(v_hat)
        torch._foreach_add_(v_hat, self.eps)
        upd = torch._foreach_div(m_hat, v_hat)
        if self.weight_decay:
            pick = [i for i, n in enumerate(self.names)
                    if self.decay is None or self.decay[n]]
            if pick:
                torch._foreach_add_([upd[i] for i in pick],
                                    [p[i] for i in pick],
                                    alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of ``tensors`` (float32)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def mask_frozen(tx: Optimizer, model: nn.Module,
                frozen_prefixes: Sequence[str] = ("text_encoder",)
                ) -> Optimizer:
    """``tx`` with the parameters under ``frozen_prefixes`` carrying no
    optimizer state and no update; ``tx`` itself when nothing is frozen."""
    mask = trainable_mask(model, frozen_prefixes)
    if all(mask.values()):
        return tx
    tx = copy.copy(tx)
    tx.trainable = mask
    return tx


def make_optimizer(peak_lr: float = 3e-4, warmup_steps: int = 1000,
                   total_steps: int = 100_000, weight_decay: float = 1e-4,
                   clip_norm: Optional[float] = 1.0, b1: float = 0.9,
                   b2: float = 0.999, params: Optional[nn.Module] = None,
                   frozen_prefixes: Sequence[str] = (),
                   skip_nonfinite_steps: int = 0) -> Optimizer:
    """AdamW with warmup-cosine LR, global-norm clipping, masked decay and
    (opt-in) frozen-module masking, as the JAX package's ``make_optimizer``.

    ``params`` (the model) enables the decay mask (otherwise every
    parameter decays, as plain adamw) and is needed for
    ``frozen_prefixes``.  ``skip_nonfinite_steps`` (optax
    ``apply_if_finite``) is not ported yet and raises."""
    if frozen_prefixes and params is None:
        raise ValueError("frozen_prefixes requires params (the masks are "
                         "built from the parameter names)")
    if skip_nonfinite_steps > 0:
        raise NotImplementedError("skip_nonfinite_steps is not ported yet")
    decay = decay_mask(params) if params is not None else None
    tx = Optimizer(warmup_cosine_schedule(peak_lr, warmup_steps,
                                          total_steps),
                   b1=b1, b2=b2, eps=1e-8, weight_decay=weight_decay,
                   clip_norm=clip_norm, decay=decay)
    if frozen_prefixes:
        tx = mask_frozen(tx, params, tuple(frozen_prefixes))
    return tx
