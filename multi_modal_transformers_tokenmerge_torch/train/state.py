"""Training state and metrics.

Counterpart of the JAX package's ``train/state.py``.  The JAX state is an
immutable pytree that a jitted step donates and returns; here the state is
one object that the step updates in place: the model (its parameters), the
optimizer with its moments, one ``torch.Generator`` per rng collection,
the step count, the metrics and an optional exponential moving average of
the parameters.  Nothing on the step's path reads a device value back to
the host, and every device value the step changes is changed in place
(the metrics' sums and counts too), so a CUDA graph of the step replays
onto the same tensors.  The step count stays a Python int, advanced once
per step by the step's Python wrapper.

Parameters are named without a gathering parametrization's path
(``core.tensor_parallel.param_name``), so that a sharded state and a
whole one share names (their checkpoints, masks and gradients).  For a
sharded model the update and the EMA run on each rank's local shards.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..core.tensor_parallel import copy_into, local, named_params
from .optim import Optimizer

__all__ = ["Metrics", "OctoTrainState", "create_train_state",
           "RNG_COLLECTIONS"]

# the stochastic pieces of the model: dropout, train-mode patch positions,
# diffusion timesteps and noise
RNG_COLLECTIONS = ("dropout", "patch_encoding", "diffusion")


class Metrics:
    """Named metric accumulators of two kinds: ``'avg'`` (sum / number of
    updates that fed it) and ``'sum'``.  Sums and counts are float32
    scalars on the device, updated in place; only :meth:`compute` followed
    by a read syncs."""

    def __init__(self, kinds: Mapping[str, str], device=None):
        for name, kind in kinds.items():
            if kind not in ("avg", "sum"):
                raise ValueError(f"metric {name!r}: kind must be 'avg' or "
                                 f"'sum', got {kind!r}")
        self.kinds = dict(sorted(kinds.items()))
        self.device = device
        self.sums = {n: torch.zeros((), device=device) for n in self.kinds}
        self.counts = {n: torch.zeros((), device=device) for n in self.kinds}

    @classmethod
    def empty(cls, device=None, **declared: str) -> "Metrics":
        """``Metrics.empty()``: running averages of loss and grad_norm."""
        return cls(declared or {"loss": "avg", "grad_norm": "avg"}, device)

    def zeros_like(self) -> "Metrics":
        return Metrics(self.kinds, self.device)

    def update(self, **values) -> "Metrics":
        """Accumulate one step's values in place; only the metrics given
        advance."""
        unknown = set(values) - set(self.sums)
        if unknown:
            raise KeyError(f"metrics {sorted(unknown)} not declared; "
                           f"declared: {sorted(self.sums)}")
        for n, v in values.items():
            self.sums[n].add_(v.detach().float()
                              if isinstance(v, torch.Tensor) else float(v))
            self.counts[n].add_(1.0)
        return self

    def compute(self) -> Dict[str, torch.Tensor]:
        return {n: (self.sums[n] / self.counts[n].clamp(min=1.0)
                    if kind == "avg" else self.sums[n].clone())
                for n, kind in self.kinds.items()}

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"kinds": dict(self.kinds), "sums": dict(self.sums),
                "counts": dict(self.counts)}


class OctoTrainState:
    """Model, optimizer, generators, step count, metrics and EMA."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 rngs: Dict[str, torch.Generator], ema_decay: float = 0.0):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.rngs = rngs
        self.metrics = Metrics.empty(next(model.parameters()).device)
        self.ema_decay = ema_decay
        self.params = dict(named_params(model))
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in self.params.items()}
            if ema_decay > 0 else None)
        # changed by every restore: a captured step made before it is not
        # replayed after it (train.steps)
        self.restored = 0

    @torch.no_grad()
    def update_parameters(self, grads: Dict[str, Optional[torch.Tensor]]):
        """The device part of :meth:`apply_gradients`: one optimizer update
        in place and the EMA after it, without advancing ``step``."""
        self.optimizer.step(self.params, grads)
        if self.ema_params is not None:
            d = self.ema_decay
            ema = [local(e) for e in self.ema_params.values()]
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [local(self.params[n]) for n in
                                      self.ema_params], alpha=1.0 - d)

    def apply_gradients(self, grads: Dict[str, Optional[torch.Tensor]]):
        """One optimizer update in place (and the EMA after it)."""
        self.update_parameters(grads)
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, object]:
        """Everything a resumed run needs: parameters, optimizer moments
        and count, EMA, metrics, step and every generator's state."""
        return {"step": self.step,
                "params": {n: p.detach() for n, p in self.params.items()},
                "optimizer": self.optimizer.state_dict(),
                "ema_params": self.ema_params,
                "metrics": self.metrics.state_dict(),
                "rngs": {n: g.get_state() for n, g in self.rngs.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Copy ``state`` (from :meth:`state_dict`) into this state's
        tensors in place and set its generators; the metrics take the saved
        declaration.  Tensors go to the state's layout: a whole tensor into
        a sharded state's shard (a replicated checkpoint restored into a
        tensor-parallel or FSDP state)."""
        for n, p in self.params.items():
            copy_into(p, state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        if (self.ema_params is None) != (state["ema_params"] is None):
            raise ValueError("the checkpoint and the state disagree on "
                             "whether an EMA is kept")
        if self.ema_params is not None:
            for n, e in self.ema_params.items():
                copy_into(e, state["ema_params"][n])
        saved = state["metrics"]
        metrics = Metrics(saved["kinds"], self.metrics.device)
        for n in metrics.kinds:
            metrics.sums[n].copy_(saved["sums"][n])
            metrics.counts[n].copy_(saved["counts"][n])
        self.metrics = metrics
        for n, g in self.rngs.items():
            g.set_state(state["rngs"][n])
        self.step = int(state["step"])
        self.restored += 1


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       rngs: Union[int, Mapping[str, torch.Generator]] = 0,
                       ema_decay: float = 0.0) -> OctoTrainState:
    """Initialize ``optimizer`` on ``model``'s parameters and wrap both.

    ``rngs``: a generator per collection of :data:`RNG_COLLECTIONS`, or an
    int seed from which they are made on the model's device."""
    device = next(model.parameters()).device
    if isinstance(rngs, int):
        seed = rngs
        rngs = {}
        for i, name in enumerate(RNG_COLLECTIONS):
            g = torch.Generator(device=device)
            g.manual_seed(seed * len(RNG_COLLECTIONS) + i)
            rngs[name] = g
    optimizer.init(named_params(model))
    return OctoTrainState(model, optimizer, dict(rngs), ema_decay=ema_decay)
