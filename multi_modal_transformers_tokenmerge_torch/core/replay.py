"""Replaying a generator's draws when a computation is run again.

Two parts of the port run a computation forward, keep only its input, and
run it again in the backward to take its gradients: the GPipe pipeline
(``parallel.pipeline``) and the rematerialized blocks of ``cfg.remat``
(``modules.attention.TransformerStack``,
``modules.tome_stack.CompressedTransformerStack``).  The recompute must
draw what the forward drew (dropout masks, the flash kernels' dropout
seed, MoE router noise), or the gradients are those of another function
than the one that ran.  The port draws from explicit ``torch.Generator``
objects, whose states ``torch.utils.checkpoint`` does not save (it saves
the default generators only), so:

* eagerly, :func:`replayed` puts each generator back at the state it had
  before the forward, for the recompute, and where it was after;
* inside a CUDA-graph capture a generator's ``get_state``/``set_state``
  are host values the graph does not replay (a replay advances the
  generator's Philox offset on the device).  A step captured by
  ``train.steps.CapturedStep`` therefore runs under a
  :class:`RecomputePlan`: its eager warm-up call measures, for every
  rematerialized call, each generator's Philox offset from the step's
  start; before the capture the plan makes one spare generator per (call,
  generator), seeded alike and registered with the graph; the captured
  recompute draws from the spare (``graphsafe_set_state``), and before
  every replay the spare's offset is set to the generator's offset at
  that replay plus the measured one.  So a replay's recompute draws what
  its forward drew, which is what the eager step draws.

:func:`checkpointed` runs one call under ``torch.utils.checkpoint`` with
this replay.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch
import torch.utils.checkpoint

__all__ = ["replayed", "checkpointed", "RecomputePlan"]


@contextlib.contextmanager
def replayed(generators: Sequence[torch.Generator], states):
    """Within the block ``generators`` are at ``states``; after it, back
    where they were."""
    now = [g.get_state() for g in generators]
    for g, st in zip(generators, states):
        g.set_state(st)
    try:
        yield
    finally:
        for g, st in zip(generators, now):
            g.set_state(st)


@contextlib.contextmanager
def _swapped(generators: Sequence[torch.Generator],
             spares: Sequence[torch.Generator]):
    """Inside a capture: within the block each generator draws from its
    spare's (registered) state; after it, from its own again."""
    now = [g.graphsafe_get_state() for g in generators]
    for g, spare in zip(generators, spares):
        g.graphsafe_set_state(spare.graphsafe_get_state())
    try:
        yield
    finally:
        for g, st in zip(generators, now):
            g.graphsafe_set_state(st)


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


# the plan of the step being warmed up or captured (innermost last)
_PLANS: List["RecomputePlan"] = []


class RecomputePlan:
    """The rematerialized calls of one captured step and the spare
    generators their recomputes draw from (see the module docstring).

    ``measuring(generators)`` wraps the eager warm-up call;
    ``register(graph)`` runs before the capture, ``capturing()`` wraps it;
    ``before_replay()`` runs before every replay.  A step with no
    rematerialized call records nothing and costs nothing."""

    def __init__(self):
        self.calls = []      # per call: [(generator, offset from the start)]
        self.spares = []     # per call: [(generator, spare, offset)]
        self._start = {}
        self._mode = None
        self._next = 0

    @contextlib.contextmanager
    def measuring(self, generators: Sequence[torch.Generator]):
        self.calls = []
        self._start = {id(g): g.get_offset() for g in generators
                       if g.device.type == "cuda"}
        with self._active("measure"):
            yield

    def register(self, graph) -> None:
        self.spares = []
        for call in self.calls:
            row = []
            for g, offset in call:
                spare = torch.Generator(device=g.device)
                spare.manual_seed(g.initial_seed())
                graph.register_generator_state(spare)
                row.append((g, spare, offset))
            self.spares.append(row)

    @contextlib.contextmanager
    def capturing(self):
        self._next = 0
        with self._active("capture"):
            yield
        if self._next != len(self.spares):
            raise RuntimeError(
                f"the captured step made {self._next} rematerialized calls, "
                f"its warm-up {len(self.spares)}")

    def before_replay(self) -> None:
        for row in self.spares:
            for g, spare, offset in row:
                spare.manual_seed(g.initial_seed())
                spare.set_offset(g.get_offset() + offset)

    @contextlib.contextmanager
    def _active(self, mode: str):
        self._mode = mode
        _PLANS.append(self)
        try:
            yield
        finally:
            _PLANS.pop()
            self._mode = None

    def _forward(self, generators) -> Optional[List[torch.Generator]]:
        """At a rematerialized call's forward: record the offsets (warm-up)
        or return the call's spares (capture)."""
        if self._mode == "measure":
            try:
                self.calls.append([(g, g.get_offset() - self._start[id(g)])
                                   for g in generators])
            except KeyError:
                raise RuntimeError(
                    "a rematerialized call draws from a generator the "
                    "captured step does not register") from None
            return None
        i, self._next = self._next, self._next + 1
        if i >= len(self.spares) or [g for g, _, _ in self.spares[i]] != \
                list(generators):
            raise RuntimeError(
                f"rematerialized call {i} of the capture does not match the "
                f"warm-up's")
        return [spare for _, spare, _ in self.spares[i]]


def checkpointed(fn: Callable, generators: Sequence[Optional[torch.Generator]],
                 *args):
    """``fn(*args)``, its activations not kept for the backward but
    recomputed there (``torch.utils.checkpoint``, non-reentrant), with the
    ``generators`` it draws from replayed for the recompute.  ``fn`` must
    return tensors (or a tuple of them) and draw from no other generator.
    Without gradients it is a plain call.  Inside a CUDA-graph capture
    with generators it needs the :class:`RecomputePlan` of
    ``train.steps.CapturedStep``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    gens = [g for g in generators if g is not None]
    plan = _PLANS[-1] if _PLANS else None
    if gens and _capturing():
        if plan is None or plan._mode != "capture":
            raise RuntimeError(
                "a rematerialized call that draws from generators inside a "
                "CUDA-graph capture needs train.steps.CapturedStep's "
                "RecomputePlan")
        spares = plan._forward(gens)
        again = lambda: _swapped(gens, spares)
    else:
        states = [g.get_state() for g in gens]
        if gens and plan is not None and plan._mode == "measure":
            plan._forward(gens)
        again = lambda: replayed(gens, states)
    runs = []

    def run(*a):
        runs.append(None)
        if len(runs) == 1:
            return fn(*a)
        with again():
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)
