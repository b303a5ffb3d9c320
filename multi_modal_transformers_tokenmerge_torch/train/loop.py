"""Training loop.

Counterpart of the JAX package's ``train/loop.py:fit``: run train steps
over a batch iterator, logging windowed metrics.  Device meshes,
checkpointing and the periodic eval hook are not ported yet; a mesh or a
checkpointer raises.
"""

from __future__ import annotations

import time
from typing import Iterable

import torch

from .state import OctoTrainState
from .steps import make_train_step

__all__ = ["fit", "to_device"]


def to_device(batch, device):
    """A host batch (numpy arrays or tensors) as tensors on ``device``."""
    return tuple(torch.as_tensor(x).to(device, non_blocking=True)
                 for x in batch)


def fit(state: OctoTrainState, batches: Iterable, head: str, num_steps: int,
        log_every: int = 50, logger=None, text_input: str = "ids",
        mesh=None, checkpointer=None) -> OctoTrainState:
    """Run ``num_steps`` train steps on ``batches`` of ``(text, images,
    actions)``, moved to the model's device.

    Every ``log_every`` steps ``logger.log(metrics, step=...)`` receives the
    metrics averaged over the steps since the previous log, the last loss
    and the steps per second; only then does the loop wait for the
    device.  The metrics restart after every log but the one at the last
    step, so the state returned holds the last window's metrics, as the
    JAX package's ``fit`` leaves them."""
    if mesh is not None:
        raise NotImplementedError("fit(mesh=...): device meshes are not "
                                  "ported yet")
    if checkpointer is not None:
        raise NotImplementedError("fit(checkpointer=...): checkpointing is "
                                  "not ported yet")
    step = make_train_step(head, text_input=text_input)
    device = next(state.model.parameters()).device
    it = iter(batches)
    t_last = time.perf_counter()
    for i in range(num_steps):
        state, loss = step(state, *to_device(next(it), device))
        if logger is not None and (i + 1) % log_every == 0:
            metrics = {k: float(v) for k, v in
                       state.metrics.compute().items()}
            now = time.perf_counter()
            sps = log_every / max(now - t_last, 1e-9)
            t_last = now
            logger.log({**metrics, "last_loss": float(loss),
                        "steps_per_sec": round(sps, 2)}, step=state.step)
            if i + 1 < num_steps:
                state.metrics = state.metrics.zeros_like()
    return state
