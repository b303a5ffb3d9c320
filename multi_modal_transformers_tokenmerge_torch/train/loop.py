"""Training loop: ``fit``, ``evaluate`` and ``graceful_stop``.

Counterpart of the JAX package's ``train/loop.py``: run train steps over a
batch iterator, logging windowed metrics, with periodic evaluation,
checkpointing (``train.checkpoint.CheckpointManager``) and a stop hook for
preemption.  The default step is the compiled one of ``train.steps`` (a
CUDA graph for a state on the card).  With a ``mesh`` every rank is handed
the global batch, as the JAX single controller is, and keeps its rows of
the ``data`` axis (``parallel.mesh.data_slice``), unless
``prefetch_to_device(mesh=)`` has cut them already; the step averages the
gradients over that axis, and ``evaluate`` averages its losses over it.
A model sharded on the mesh (``parallel.mesh.shard_params``) trains and
evaluates on its shards through the same calls.
"""

from __future__ import annotations

import signal
import time
import weakref
from typing import Callable, Dict, Iterable, Optional

import torch

from ..core.global_batch import all_reduce_sum, data_parallel
from ..parallel.mesh import DATA_AXIS, data_info, data_slice, mesh_size
from ..utils.data import Prefetched
from .state import Metrics, OctoTrainState
from .steps import (LOSS_METHODS, LOSS_METHODS_WITH_TEXT, CapturedStep,
                    make_train_step)

__all__ = ["fit", "evaluate", "graceful_stop", "to_device", "eval_seed",
           "EVAL_FOLD"]

# the fixed offset evaluate() folds into every generator seed, with the
# batch index (the JAX package folds 0xE7A1, then i, into each key)
EVAL_FOLD = 0xE7A1


def _rows_to_cut(batches, mesh, microbatches: int = 1):
    """The mesh whose rows fit and evaluate cut from each batch: None for
    batches that ``prefetch_to_device(mesh=mesh)`` has cut already.  Such
    batches with another mesh, or with none, or cut into another number of
    microbatches, raise: the step would train on other rows than its
    own."""
    if not isinstance(batches, Prefetched) or batches.rows_of is None:
        return mesh
    if (mesh is None or batches.rows_of != mesh
            or batches.microbatches != microbatches):
        raise ValueError("these batches were cut to a rank's rows by "
                         "prefetch_to_device for another mesh or number of "
                         "microbatches than this call's; pass the same "
                         "mesh, and accum_steps as its microbatches")
    return None


def to_device(batch, device, mesh=None, microbatches: int = 1):
    """A host batch (numpy arrays or tensors) as tensors on ``device``;
    with a ``mesh`` this rank's rows of it (of each of ``microbatches``
    global microbatches, ``parallel.mesh.data_slice``)."""
    return tuple(torch.as_tensor(data_slice(x, mesh,
                                            microbatches=microbatches)).to(
                     device, non_blocking=True)
                 for x in batch)


def graceful_stop(signals=(signal.SIGTERM, signal.SIGINT)):
    """A zero-argument callable that turns True once any of ``signals``
    arrives: pass it as ``fit(should_stop=...)`` so that a preempted run
    checkpoints and returns instead of dying mid-step.

    Handlers installed before are chained, except Python's default SIGINT
    handler, which raises KeyboardInterrupt and would end the run before
    its final checkpoint.  The first SIGINT therefore stops the run
    gracefully; a second one raises KeyboardInterrupt.  SIGTERMs do not
    count towards that second SIGINT."""
    state = {"stop": False, "sigints": 0}

    def make_handler(prev):
        def handler(signum, frame):
            if signum == getattr(signal, "SIGINT", None):
                state["sigints"] += 1
                if state["sigints"] >= 2:
                    raise KeyboardInterrupt
            state["stop"] = True
            if callable(prev) and prev is not signal.default_int_handler:
                prev(signum, frame)
        return handler

    for s in signals:
        signal.signal(s, make_handler(signal.getsignal(s)))
    return lambda: state["stop"]


def fit(state: OctoTrainState, batches: Iterable, head: str, num_steps: int,
        mesh=None, logger=None, log_every: int = 50,
        reset_metrics_on_log: bool = True, checkpointer=None,
        checkpoint_every: int = 1000, step_fn: Optional[Callable] = None,
        eval_fn: Optional[Callable] = None, eval_every: int = 0,
        text_input: str = "ids", data_state_fn: Optional[Callable] = None,
        should_stop: Optional[Callable] = None,
        accum_steps: int = 1) -> OctoTrainState:
    """Run ``num_steps`` train steps on ``batches`` of ``(text, images,
    actions)``, moved to the model's device.

    Every ``log_every`` steps ``logger.log(metrics, step=...)`` receives the
    metrics averaged over the steps since the previous log (with
    ``reset_metrics_on_log``; else since the start), the last loss and the
    steps per second; only then does the loop wait for the device.  The
    metrics restart after every log but the one at the last step, so the
    state returned holds the last window's metrics.

    ``step_fn`` replaces the default step (``make_train_step(head,
    text_input=text_input, accum_steps=accum_steps)``; ``accum_steps`` is
    the JAX step's option, which the JAX ``fit`` reaches through its
    ``step_fn``).  ``eval_fn(state) -> dict`` runs every
    ``eval_every`` steps and is logged under ``eval/``; the latest result
    rides along with every checkpoint save, so a ``CheckpointManager`` with
    ``best_metric`` keeps the best checkpoints.  ``checkpointer.save`` runs
    every ``checkpoint_every`` steps and once at the end (then ``wait()``),
    with ``data_state_fn()`` (e.g. ``RecordReader.state``) saved beside
    it.  A ``CheckpointManager`` saves asynchronously: the loop goes on
    while a save is written, and the final ``wait()`` returns once the
    last one has landed.  ``should_stop()`` (e.g. :func:`graceful_stop`)
    is polled once a step; when it turns true the loop saves (with a
    checkpointer), waits for the save and returns early.

    ``mesh``: data parallel over its ``data`` axis; each rank keeps its
    rows of every batch, of each of its ``accum_steps`` microbatches (the
    batch must divide by the data size times ``accum_steps``; batches from
    ``prefetch_to_device(mesh=mesh, microbatches=accum_steps)`` are those
    rows already) and the
    default step is ``make_train_step(head, mesh=mesh)``, compiled at a
    mesh of one rank and eager above it (a CUDA graph does not hold the
    collectives).  A model sharded on the mesh trains on its shards.  A
    ``step_fn`` of one's own must be made with the same mesh."""
    step = (step_fn if step_fn is not None
            else make_train_step(head, text_input=text_input, mesh=mesh,
                                 jit=mesh_size(mesh) == 1,
                                 accum_steps=accum_steps))
    device = next(state.model.parameters()).device
    cut = _rows_to_cut(batches, mesh, accum_steps)
    it = iter(batches)
    last_eval = None
    t_last = time.perf_counter()
    for i in range(num_steps):
        state, loss = step(state, *to_device(next(it), device, cut,
                                             accum_steps))
        if logger is not None and (i + 1) % log_every == 0:
            metrics = {k: float(v) for k, v in
                       state.metrics.compute().items()}
            now = time.perf_counter()
            sps = log_every / max(now - t_last, 1e-9)
            t_last = now
            logger.log({**metrics, "last_loss": float(loss),
                        "steps_per_sec": round(sps, 2)}, step=state.step)
            if reset_metrics_on_log and i + 1 < num_steps:
                state.metrics = state.metrics.zeros_like()
        if eval_fn is not None and eval_every and (i + 1) % eval_every == 0:
            last_eval = {k: float(v) for k, v in eval_fn(state).items()}
            if logger is not None:
                logger.log({f"eval/{k}": v for k, v in last_eval.items()},
                           step=state.step)
        if checkpointer is not None and (i + 1) % checkpoint_every == 0:
            checkpointer.save(state.step, state,
                              data_state=_maybe(data_state_fn),
                              metrics=last_eval)
        if should_stop is not None and should_stop():
            break
    if checkpointer is not None:
        checkpointer.save(state.step, state,
                          data_state=_maybe(data_state_fn), metrics=last_eval)
        checkpointer.wait()
    return state


def _maybe(fn):
    return fn() if fn is not None else None


def eval_seed(seed: int, i: int) -> int:
    """The seed of batch ``i``'s generator, from a training generator's
    initial seed, :data:`EVAL_FOLD` and ``i`` (a 64-bit mix)."""
    x = seed & 0xFFFFFFFFFFFFFFFF
    for word in (EVAL_FOLD, i):
        x = (x ^ (word + 0x9E3779B97F4A7C15 + (x << 6) + (x >> 2))
             ) & 0xFFFFFFFFFFFFFFFF
    return x & 0x7FFFFFFFFFFFFFFF


# state -> {collection: generator}: evaluate's own generators, reseeded for
# every batch, never the training ones
_EVAL_RNGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# (head, text_input, mesh) -> the eval loss's step (a CapturedStep, eager
# under a mesh of more than one rank)
_EVAL_STEPS: Dict = {}


def _eval_rngs(state: OctoTrainState) -> Dict[str, torch.Generator]:
    if state not in _EVAL_RNGS:
        _EVAL_RNGS[state] = {n: torch.Generator(device=g.device)
                             for n, g in state.rngs.items()}
    return _EVAL_RNGS[state]


def _eval_step(head: str, text_input: str, mesh=None) -> Callable:
    """The eval loss of ``head`` as a captured step (eager on the CPU);
    with a mesh the rank's loss, its draws made for the global batch."""
    key = (head, text_input, mesh)
    if key not in _EVAL_STEPS:
        group = mesh.get_group(DATA_AXIS) if mesh is not None else None
        method = (LOSS_METHODS if text_input == "ids"
                  else LOSS_METHODS_WITH_TEXT)[head]

        @torch.no_grad()
        def body(state, text, images, actions, *, draws=None):
            loss_fn = getattr(state.model, method)
            with data_parallel(group):
                return loss_fn(text, images, actions, False,
                               rngs=_eval_rngs(state)).mean().float()

        if mesh_size(mesh) > 1:
            # eager: a CUDA graph does not hold a sharded model's
            # collectives
            _EVAL_STEPS[key] = lambda state, *batch: (state,
                                                      body(state, *batch))
        else:
            _EVAL_STEPS[key] = CapturedStep(
                body, after=lambda state: None,
                generators=lambda state: _eval_rngs(state).values())
    return _EVAL_STEPS[key]


def evaluate(state: OctoTrainState, batches: Iterable, head: str,
             num_batches: int, mesh=None, text_input: str = "ids") -> dict:
    """The head's loss averaged over ``num_batches`` held-out batches: eval
    mode (dropout off, deterministic patch positions), no gradients, no
    change to the state.

    Deterministic: the stochastic pieces (diffusion times and noise) draw
    from generators of evaluate's own, seeded for batch ``i`` from each
    training generator's initial seed, :data:`EVAL_FOLD` and ``i``
    (:func:`eval_seed`); the training generators do not advance.  On the
    card the loss is a captured step, as the train step is.  With a
    ``mesh`` each rank evaluates its rows of every batch (the diffusion
    draws made for the global batch) and the losses are averaged over the
    data axis, so every rank returns the global average."""
    if head not in LOSS_METHODS:
        raise ValueError(f"unknown head {head!r}; one of "
                         f"{sorted(LOSS_METHODS)}")
    data_size = data_info(mesh)[1]
    device = next(state.model.parameters()).device
    step = _eval_step(head, text_input, mesh)
    rngs = _eval_rngs(state)
    metrics = Metrics.empty(device, loss="avg")
    cut = _rows_to_cut(batches, mesh)
    it = iter(batches)
    for i in range(num_batches):
        batch = to_device(next(it), device, cut)
        for name, g in rngs.items():
            g.manual_seed(eval_seed(state.rngs[name].initial_seed(), i))
        _, loss = step(state, *batch)
        if data_size > 1:
            loss = all_reduce_sum(loss, mesh.get_group(DATA_AXIS)) * (
                1.0 / data_size)
        metrics.update(loss=loss)
    return {k: float(v) for k, v in metrics.compute().items()}
