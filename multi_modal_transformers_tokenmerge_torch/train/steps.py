"""Train steps.

Counterpart of the JAX package's ``train/steps.py``: one step computes the
head's loss in train mode (the mean over the batch of the diffusion,
continuous L2 or categorical cross-entropy loss), its gradients, the global
gradient norm (before clipping), one optimizer update and the metrics.

With ``accum_steps`` > 1 the batch splits into that many microbatches,
each with fresh draws from the generators; their gradients are summed in
float32, averaged and cast to the parameter dtype, and the loss averaged,
before one update.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from .optim import global_norm
from .state import OctoTrainState

__all__ = ["make_train_step", "LOSS_METHODS", "LOSS_METHODS_WITH_TEXT"]

LOSS_METHODS = {
    "continuous": "compute_l2_loss",
    "categorical": "compute_ce_loss",
    "diffusion": "compute_diffusion_denoise_loss",
}
# the first batch element is (B, T, E) text embeddings instead of (B, T)
# ids, valid for a frozen text tower (utils.data.cache_text_embeddings)
LOSS_METHODS_WITH_TEXT = {
    "continuous": "compute_l2_loss_with_text",
    "categorical": "compute_ce_loss_with_text",
    "diffusion": "compute_diffusion_denoise_loss_with_text",
}


def _split_draws(draws: Optional[Mapping], i: int, n: int) -> Dict:
    """Microbatch ``i`` of ``n`` of the explicit draws (each split along
    its batch dim; ``positions`` is a (rows, cols) pair)."""
    if not draws:
        return {}
    out = {}
    for k, v in draws.items():
        if k == "positions":
            out[k] = tuple(t.chunk(n)[i] for t in v)
        else:
            out[k] = v.chunk(n)[i]
    return out


def make_train_step(head: str, accum_steps: int = 1,
                    text_input: str = "ids") -> Callable:
    """Build ``step(state, text, images, actions, *, draws=None) ->
    (state, loss)``; the state is updated in place and returned.

    ``draws`` optionally replaces the generators' train-mode draws:
    ``positions`` ((B, F, P) rows, cols) and, for the diffusion head,
    ``time`` (B, 1) and ``noise`` (B, A).
    ``text_input='embeddings'`` takes the frozen text tower's (B, T, E)
    output instead of ids."""
    if text_input not in ("ids", "embeddings"):
        raise ValueError(
            f"text_input must be 'ids' or 'embeddings', got {text_input!r}")
    methods = (LOSS_METHODS if text_input == "ids"
               else LOSS_METHODS_WITH_TEXT)
    if head not in methods:
        raise ValueError(f"unknown head {head!r}; one of {sorted(methods)}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be >= 1")
    method = methods[head]

    def step(state: OctoTrainState, text, images, actions, *,
             draws: Optional[Mapping] = None):
        model = state.model
        loss_fn = getattr(model, method)
        names = [n for n, p in state.params.items() if p.requires_grad]
        params = [state.params[n] for n in names]
        b = actions.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps={accum_steps}")
        if accum_steps == 1:
            loss = loss_fn(text, images, actions, True, rngs=state.rngs,
                           **(draws or {})).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        else:
            loss = torch.zeros((), device=actions.device)
            sums = [None] * len(params)
            for i in range(accum_steps):
                mb = lambda x: x.chunk(accum_steps)[i]
                l_i = loss_fn(mb(text), mb(images), mb(actions), True,
                              rngs=state.rngs,
                              **_split_draws(draws, i, accum_steps)).mean()
                g_i = torch.autograd.grad(l_i, params, allow_unused=True)
                loss = loss + l_i.detach()
                sums = [s if g is None else
                        (g.float() if s is None else s + g.float())
                        for s, g in zip(sums, g_i)]
            inv = 1.0 / accum_steps
            loss = loss * inv
            grads = [None if s is None else (s * inv).to(p.dtype)
                     for s, p in zip(sums, params)]
        grads = dict(zip(names, grads))
        present = [g for g in grads.values() if g is not None]
        grad_norm = (global_norm(present) if present
                     else torch.zeros((), device=actions.device))
        state.apply_gradients(grads)
        loss = loss.detach()
        std = {k: v for k, v in (("loss", loss), ("grad_norm", grad_norm))
               if k in state.metrics.sums}
        state.metrics.update(**std)
        return state, loss

    return step
