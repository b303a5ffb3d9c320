"""Mixture-of-experts MLP block: GShard / Switch dense dispatch.

Counterpart of the JAX package's ``modules/moe.py``, a drop-in for the
encoder block's dense MLP (``TransformerConfig.mlp_type='moe'``):

* routing makes static-shape one-hot dispatch and combine tensors
  (B, S, E, C); dispatch, the experts and combine are einsums;
* the router runs in float32 whatever the compute dtype, and at train time
  ``router_noise`` jitters its logits multiplicatively, uniform in
  [1 - r, 1 + r], drawn from the ``dropout`` generator;
* the top-k choice breaks ties toward the lower expert index, as
  ``jax.lax.top_k`` does (a stable sort; ``torch.topk`` on the card
  promises no order among ties);
* capacity is slot-major: every token's first choice is granted before any
  token's second; tokens past an expert's capacity C contribute zero and
  fall through to the block's residual;
* expert parameters are stacked (E, ...) in the flax layout
  (``expert_wi`` (E, D, F), ``expert_bi`` (E, F), ``expert_wo`` (E, F, D),
  ``expert_bo`` (E, D));
* the Switch load-balance loss (E * sum_e fraction_e * mean_prob_e over the
  top-1 choices before capacity; 1.0 when uniform) is returned beside the
  output.  The stacks sum it, weight it by ``aux_loss_weight`` and hand it
  to the train step, which adds it to the loss (the JAX package's
  ``'losses'`` collection).  In a data-parallel step
  (``core.global_batch.data_parallel``) both means are taken over the
  global batch, as the JAX SPMD step takes them.

Expert parallelism (``parallel.mesh.shard_params`` with a model axis,
the JAX rules' expert dim over ``model``): each rank holds and runs its
``E / P`` experts on the tokens dispatched to them, the combine contracts
over its experts, and the partial outputs are summed over ``model``
(``core.tensor_parallel``).  The router is replicated, so every rank
computes the same dispatch, capacity and balance loss; the gradient that
reaches the router through the combine weights is summed over ``model``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from ..core.config import MoEConfig
from ..core.global_batch import all_reduce_sum, data_group, draw_global
from ..core.tensor_parallel import from_model, local, model_split, to_model
from .layers import activation_fn, init_normal, init_truncated

__all__ = ["MoEMLPBlock", "moe_capacity", "sum_aux"]


def moe_capacity(cfg: MoEConfig, seq_len: int) -> int:
    """Per-expert token capacity C for a sequence of S tokens."""
    c = cfg.top_k * seq_len * cfg.capacity_factor / cfg.num_experts
    return max(1, int(-(-c // 1)))  # ceil


def sum_aux(terms, weight: float) -> Optional[torch.Tensor]:
    """The pre-weighted objective term of a stack: ``weight`` times the sum
    of its blocks' balance losses (float32), or None when it has none."""
    if not terms:
        return None
    return torch.stack(terms).sum() * weight


class _Router(nn.Module):
    """Bias-free float32 router dense, normal(0.01) init."""

    def __init__(self, features: int, experts: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, features,
                                               dtype=torch.float32,
                                               device=device))

    def reset_parameters(self, generator) -> None:
        init_normal(self.weight, 1e-2, generator)

    def forward(self, x):
        return x.float() @ self.weight.float().t()


class MoEMLPBlock(nn.Module):
    """Routed two-layer MLP, ``combine(expert_mlp(dispatch(x)))``; forward
    returns ``(y, aux)``, y in the compute dtype and aux the float32 Switch
    balance loss."""

    CAST_PARAMS = ("expert_wi", "expert_bi", "expert_wo", "expert_bo")

    def __init__(self, cfg: MoEConfig, in_dim: int, mlp_dim: int,
                 out_dim: int, activation: str = "relu", *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.act = activation_fn(activation)
        e = cfg.num_experts
        if not 1 <= cfg.top_k <= e:
            raise ValueError(f"top_k={cfg.top_k} outside [1, {e}] experts")
        self.router = _Router(in_dim, e, device=device)
        param = lambda *shape: nn.Parameter(torch.empty(
            *shape, dtype=param_dtype, device=device))
        self.expert_wi = param(e, in_dim, mlp_dim)
        self.expert_bi = param(e, mlp_dim)
        self.expert_wo = param(e, mlp_dim, out_dim)
        self.expert_bo = param(e, out_dim)

    def reset_parameters(self, generator) -> None:
        # flax he_normal on (E, D, F): fan_in counts the expert axis too
        e = self.cfg.num_experts
        for w in (self.expert_wi, self.expert_wo):
            init_truncated(w, math.sqrt(2.0 / (e * w.shape[1])), generator)
        for b in (self.expert_bi, self.expert_bo):
            init_normal(b, 1e-2, generator)

    def route(self, x: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None):
        """(B, S, D) -> dispatch, combine (B, S, E, C) float32, the router's
        probabilities (B, S, E) and the top-k choices (B, S, k)."""
        c = self.cfg
        b, s, _ = x.shape
        e, k = c.num_experts, c.top_k
        cap = moe_capacity(c, s)
        logits = self.router(x)
        if train and c.router_noise > 0.0:
            if generator is None:
                raise ValueError("router_noise in train mode needs a "
                                 "'dropout' generator")
            u = draw_global(lambda s: torch.rand(
                s, generator=generator, device=logits.device), logits.shape)
            logits = logits * (u * (2.0 * c.router_noise)
                               + (1.0 - c.router_noise))
        probs = torch.softmax(logits, dim=-1)
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :k]
        gate = probs.gather(-1, idx)
        if k > 1:
            gate = gate / gate.sum(dim=-1, keepdim=True)

        experts = torch.arange(e, device=x.device)
        sel = (idx[..., None] == experts).float()            # (B, S, k, E)
        # rows ordered (slot, position): all first choices before seconds
        sel_flat = sel.transpose(1, 2).reshape(b, k * s, e)
        pos_flat = torch.cumsum(sel_flat, dim=1) - sel_flat
        keep_flat = sel_flat * (pos_flat < cap)
        pos = pos_flat.reshape(b, k, s, e).transpose(1, 2)
        keep = keep_flat.reshape(b, k, s, e).transpose(1, 2)
        slots = torch.arange(cap, device=x.device, dtype=pos.dtype)
        slot = (pos[..., None] == slots).float() * keep[..., None]
        dispatch = slot.sum(dim=2)                           # (B, S, E, C)
        combine = torch.einsum("bsk,bskec->bsec", gate, slot)
        return dispatch, combine, probs, sel

    def split(self):
        """The model-axis split of the expert stacks (the expert dim), or
        None when every rank holds every expert."""
        splits = [None if parametrize.is_parametrized(self, n)
                  else model_split(getattr(self, n))
                  for n in self.CAST_PARAMS]
        if all(s is not None and s.dim == 0 for s in splits):
            return splits[0]
        return None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        dispatch, combine, probs, sel = self.route(x, train, generator)
        split = self.split()
        wi, bi, wo, bo = (local(getattr(self, n)).to(dt)
                          for n in self.CAST_PARAMS)
        if split is not None:
            # this rank's experts; the combine weights' gradient from them
            # is summed over the model axis before it reaches the router
            e0, n = split.rank * wi.shape[0], wi.shape[0]
            x = to_model(x, split)
            dispatch = dispatch.narrow(2, e0, n)
            combine = to_model(combine, split).narrow(2, e0, n)
        xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x.to(dt))
        h = self.act(torch.einsum("ebcd,edf->ebcf", xin, wi)
                     + bi[:, None, None, :])
        out = torch.einsum("ebcf,efd->ebcd", h, wo) + bo[:, None, None, :]
        y = from_model(torch.einsum("bsec,ebcd->bsd", combine.to(dt), out),
                       split)
        # Switch balance loss on the top-1 choices before capacity, over
        # the global batch in a data-parallel step: the means are averaged
        # over the data ranks before their product
        frac = sel[:, :, 0, :].mean(dim=(0, 1))
        mean_prob = probs.mean(dim=(0, 1))
        group = data_group()
        if group is not None and dist.get_world_size(group) > 1:
            inv = 1.0 / dist.get_world_size(group)
            frac = all_reduce_sum(frac, group) * inv
            mean_prob = all_reduce_sum(mean_prob, group) * inv
        aux = self.cfg.num_experts * (frac * mean_prob).sum()
        return y.to(dt), aux.float()
