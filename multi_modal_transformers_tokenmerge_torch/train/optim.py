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
tree per step).  Its step count lives on the device, and the learning rate
and the bias corrections are computed from it there, so one update reads
nothing back from the device and a CUDA graph that captures it (the
compiled step of ``train.steps``) replays every later update correctly.

For a sharded model (``parallel.mesh.shard_params``) it works on each
rank's shards, as optax works on sharded leaves: the moments are created
on the parameter's shards (1/P of its memory a rank), the update reads
the local shards of parameters and gradients, and the global norm and the
finite check sum each rank's local squares and all-reduce that sum, every
element counted once (``global_norm``).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..core.tensor_parallel import (copy_into, local, named_params,
                                    param_name, replicas)

__all__ = ["warmup_cosine_schedule", "make_optimizer", "decay_mask",
           "trainable_mask", "mask_frozen", "global_norm", "shard_replicas",
           "Optimizer"]


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           end_lr_ratio: float = 0.1) -> Callable:
    """optax ``warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    max(total_steps, warmup_steps + 1), peak_lr * end_lr_ratio)``: linear
    from 0 over the warmup, then cosine down to the end value.

    Called with a tensor count (the optimizer's, on the device) the
    schedule returns the rate as a float32 tensor on that device, with
    optax's float32 arithmetic; called with an int it returns a float."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    end_lr = peak_lr * end_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr

    def schedule(count):
        if not isinstance(count, torch.Tensor):
            return float(schedule(torch.tensor(count, dtype=torch.float64)))
        c = count if count.is_floating_point() else count.float()
        decay_c = torch.clamp(c - warmup_steps, max=decay_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * decay_c / decay_steps))
        out = peak_lr * ((1.0 - alpha) * cosine + alpha)
        if warmup_steps > 0:
            frac = 1.0 - torch.clamp(c, 0, warmup_steps) / warmup_steps
            out = torch.where(c < warmup_steps, -peak_lr * frac + peak_lr,
                              out)
        return out

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
    embeddings = {f"{n}.weight" if n else "weight"
                  for n, m in model.named_modules() if isinstance(m, Embed)}
    scanned = tuple(".".join(s) + "." for s in scanned_stacks(model.config))
    out = {}
    for name, p in named_params(model):
        parts = name.split(".")
        if name in embeddings or parts[-1] == "pos_embedding":
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
            for name, _ in named_params(model)}


class Optimizer:
    """The optax chain ``[apply_if_finite]([masked](clip_by_global_norm,
    adamw(schedule, b1, b2, eps, weight_decay, mask)), n)`` over named
    parameters.

    :meth:`init` creates the moments of the trainable parameters and the
    step count (int32, on the parameters' device); :meth:`step` applies one
    update in place.  Frozen parameters carry no state and are never
    changed.  A sharded parameter (a DTensor) has its moments as DTensors
    of the same placements; the arithmetic runs on the local shards.

    ``skip_nonfinite`` = n > 0 is optax's ``apply_if_finite(tx, n)``: an
    update whose gradients hold an inf or a NaN leaves the parameters, the
    moments and ``count`` as they were, unless it is the (n+1)-th such
    update in a row, which applies.  ``notfinite_count`` (in a row),
    ``last_finite`` and ``total_notfinite`` are optax's counters.  The
    choice is made on the device, with no branch on the host."""

    def __init__(self, schedule: Callable, *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 clip_norm: Optional[float],
                 decay: Optional[Dict[str, bool]] = None,
                 trainable: Optional[Dict[str, bool]] = None,
                 skip_nonfinite: int = 0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.decay = decay
        self.trainable = trainable
        self.skip_nonfinite = skip_nonfinite
        self.count: Optional[torch.Tensor] = None
        self.names: List[str] = []
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        self.notfinite_count = self.last_finite = None
        self.total_notfinite = None
        self.replicas: Optional[List[int]] = None

    def init(self, named_params: Iterable) -> None:
        params = {param_name(n): p for n, p in named_params}
        device = next(iter(params.values())).device if params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.names = [n for n in params
                      if self.trainable is None or self.trainable[n]]
        self.mu = [_zeros_on_shards(params[n]) for n in self.names]
        self.nu = [_zeros_on_shards(params[n]) for n in self.names]
        self.replicas = shard_replicas([params[n] for n in self.names])
        if self.skip_nonfinite:
            self.notfinite_count = torch.zeros((), dtype=torch.int32,
                                               device=device)
            self.last_finite = torch.ones((), dtype=torch.bool,
                                          device=device)
            self.total_notfinite = torch.zeros((), dtype=torch.int32,
                                               device=device)

    def state_dict(self) -> Dict[str, object]:
        """The optimizer's tensors by name (moments keyed by parameter)."""
        out = {"count": self.count,
               "mu": dict(zip(self.names, self.mu)),
               "nu": dict(zip(self.names, self.nu))}
        if self.skip_nonfinite:
            out.update(notfinite_count=self.notfinite_count,
                       last_finite=self.last_finite,
                       total_notfinite=self.total_notfinite)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy ``state`` (from :meth:`state_dict`) into this optimizer's
        tensors in place."""
        for name, mine in self.state_dict().items():
            if isinstance(mine, dict):
                for n, t in mine.items():
                    copy_into(t, state[name][n])
            else:
                mine.copy_(state[name])

    def hyperparameters(self, count: torch.Tensor):
        """(learning rate, 1 - b1^(count+1), 1 - b2^(count+1)) of the update
        at ``count`` (counted from 0), as float32 tensors on its device."""
        nxt = (count + 1).float()
        return (self.schedule(count), 1.0 - torch.pow(self.b1, nxt),
                1.0 - torch.pow(self.b2, nxt))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One update of ``params`` (name -> tensor) from ``grads`` (name ->
        gradient, or None for none); the gradients may be scaled in place.
        A sharded parameter's gradient is this rank's shard of it, a plain
        tensor of the shard's shape (``train.steps``)."""
        p = [local(params[n]) for n in self.names]
        g = [local(grads[n]) if grads.get(n) is not None
             else torch.zeros_like(p[i]) for i, n in enumerate(self.names)]
        apply = None
        if self.skip_nonfinite:
            # every gradient handed in counts, frozen ones too (optax's
            # apply_if_finite wraps the masked chain)
            present = [n for n, t in grads.items() if t is not None]
            apply = self._check_finite(
                [local(grads[n]) for n in present],
                shard_replicas([params[n] for n in present]))
        if self.clip_norm is not None and g:
            norm = global_norm(g, self.replicas)
            scale = torch.where(norm < self.clip_norm, 1.0,
                                self.clip_norm / norm)
            torch._foreach_mul_(g, scale)
        b1, b2 = self.b1, self.b2
        lr, bc1, bc2 = self.hyperparameters(self.count)
        moments = ([local(m) for m in self.mu], [local(v) for v in self.nu])
        if apply is None:
            mu, nu = moments
            torch._foreach_mul_(mu, b1)
            torch._foreach_mul_(nu, b2)
        else:
            mu = torch._foreach_mul(moments[0], b1)
            nu = torch._foreach_mul(moments[1], b2)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        m_hat = torch._foreach_div(mu, bc1)
        v_hat = torch._foreach_div(nu, bc2)
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
        torch._foreach_mul_(upd, -lr)
        if apply is not None:
            # a rejected update leaves moments, parameters and count as
            # they were (optax returns zero updates and the old state)
            for old, new in zip(moments, (mu, nu)):
                for o, n in zip(old, new):
                    o.copy_(torch.where(apply, n, o))
            upd = [torch.where(apply, u, 0.0) for u in upd]
            self.count.add_(apply.int())
        else:
            self.count.add_(1)
        torch._foreach_add_(p, upd)

    def _check_finite(self, grads: List[torch.Tensor],
                      reps: Optional[List[int]]) -> torch.Tensor:
        """Advance optax's counters on the device; True where the update
        applies (finite, or past ``skip_nonfinite`` bad updates in a
        row).  ``reps``: :func:`global_norm`'s, so that every rank of a
        sharded model takes the same choice."""
        zeros = torch._foreach_mul(grads, 0.0)   # NaN where not finite
        if not zeros:
            finite = torch.ones((), dtype=torch.bool,
                                device=self.count.device)
        elif reps is None:
            finite = torch.stack(torch._foreach_norm(zeros)).sum() == 0
        else:
            finite = global_norm(zeros, reps) == 0
        self.notfinite_count.copy_(torch.where(
            finite, 0, self.notfinite_count + 1))
        self.total_notfinite.add_((~finite).int())
        self.last_finite.copy_(finite)
        return finite | (self.notfinite_count > self.skip_nonfinite)


def global_norm(tensors: Sequence[torch.Tensor],
                replicas: Optional[Sequence[int]] = None) -> torch.Tensor:
    """sqrt(sum of squares) over every element of ``tensors`` (float32).

    ``replicas`` (from :func:`shard_replicas`): the tensors are this
    rank's shards of a sharded model's tensors, tensor i held alike on
    ``replicas[i]`` ranks.  Each rank sums its squares, each weighted by
    1 / replicas, and the sum is all-reduced over the world, so that every
    element counts once and every rank gets the same norm."""
    norms = torch._foreach_norm([local(t).float() for t in tensors])
    if replicas is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    weights = torch.tensor([1.0 / r for r in replicas],
                           device=norms[0].device)
    total = (torch.stack(norms).square() * weights).sum()
    dist.all_reduce(total)
    return total.sqrt()


def shard_replicas(tensors: Sequence[torch.Tensor]) -> Optional[List[int]]:
    """On how many ranks each tensor's elements live
    (``core.tensor_parallel.replicas``), or None when none is sharded: the
    ``replicas`` of :func:`global_norm`."""
    if not any(hasattr(t, "placements") for t in tensors):
        return None
    return [replicas(t) for t in tensors]


def _zeros_on_shards(p: torch.Tensor) -> torch.Tensor:
    """Zeros of ``p``'s shape, on its shards for a DTensor (each rank
    allocates its shard only)."""
    if not hasattr(p, "placements"):
        return torch.zeros_like(p)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(torch.zeros_like(p.to_local()), p.device_mesh,
                              p.placements, run_check=False)


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
    ``frozen_prefixes``.  ``skip_nonfinite_steps`` > 0 wraps the chain as
    optax ``apply_if_finite`` does (see :class:`Optimizer`)."""
    if frozen_prefixes and params is None:
        raise ValueError("frozen_prefixes requires params (the masks are "
                         "built from the parameter names)")
    decay = decay_mask(params) if params is not None else None
    tx = Optimizer(warmup_cosine_schedule(peak_lr, warmup_steps,
                                          total_steps),
                   b1=b1, b2=b2, eps=1e-8, weight_decay=weight_decay,
                   clip_norm=clip_norm, decay=decay,
                   skip_nonfinite=max(skip_nonfinite_steps, 0))
    if frozen_prefixes:
        tx = mask_frozen(tx, params, tuple(frozen_prefixes))
    return tx
