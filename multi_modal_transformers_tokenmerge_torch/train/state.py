"""Training state and metrics.

Counterpart of the JAX package's ``train/state.py``.  The JAX state is an
immutable pytree that a jitted step donates and returns; here the state is
one object that the step updates in place: the model (its parameters), the
optimizer with its moments, one ``torch.Generator`` per rng collection,
the step count, the metrics and an optional exponential moving average of
the parameters.  Nothing on the step's path reads a device value back to
the host.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from .optim import Optimizer

__all__ = ["Metrics", "OctoTrainState", "create_train_state",
           "RNG_COLLECTIONS"]

# the stochastic pieces of the model: dropout, train-mode patch positions,
# diffusion timesteps and noise
RNG_COLLECTIONS = ("dropout", "patch_encoding", "diffusion")


class Metrics:
    """Named metric accumulators of two kinds: ``'avg'`` (sum / number of
    updates that fed it) and ``'sum'``.  Sums stay on the device; only
    :meth:`compute` followed by a read syncs."""

    def __init__(self, kinds: Mapping[str, str], device=None):
        for name, kind in kinds.items():
            if kind not in ("avg", "sum"):
                raise ValueError(f"metric {name!r}: kind must be 'avg' or "
                                 f"'sum', got {kind!r}")
        self.kinds = dict(sorted(kinds.items()))
        self.device = device
        self.sums = {n: torch.zeros((), device=device) for n in self.kinds}
        self.counts = {n: 0 for n in self.kinds}

    @classmethod
    def empty(cls, device=None, **declared: str) -> "Metrics":
        """``Metrics.empty()``: running averages of loss and grad_norm."""
        return cls(declared or {"loss": "avg", "grad_norm": "avg"}, device)

    def zeros_like(self) -> "Metrics":
        return Metrics(self.kinds, self.device)

    def update(self, **values) -> "Metrics":
        """Accumulate one step's values; only the metrics given advance."""
        unknown = set(values) - set(self.sums)
        if unknown:
            raise KeyError(f"metrics {sorted(unknown)} not declared; "
                           f"declared: {sorted(self.sums)}")
        for n, v in values.items():
            self.sums[n] = self.sums[n] + torch.as_tensor(
                v, device=self.sums[n].device).detach().float()
            self.counts[n] += 1
        return self

    def compute(self) -> Dict[str, torch.Tensor]:
        return {n: (self.sums[n] / max(self.counts[n], 1)
                    if kind == "avg" else self.sums[n])
                for n, kind in self.kinds.items()}


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
        self.params = dict(model.named_parameters())
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in self.params.items()}
            if ema_decay > 0 else None)

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, Optional[torch.Tensor]]):
        """One optimizer update in place (and the EMA after it)."""
        self.optimizer.step(self.params, grads)
        if self.ema_params is not None:
            d = self.ema_decay
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [self.params[n] for n in
                                      self.ema_params], alpha=1.0 - d)
        self.step += 1
        return self


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
    optimizer.init(model.named_parameters())
    return OctoTrainState(model, optimizer, dict(rngs), ema_decay=ema_decay)
