"""Train steps.

Counterpart of the JAX package's ``train/steps.py``: one step computes the
head's loss in train mode (the mean over the batch of the diffusion,
continuous L2 or categorical cross-entropy loss), its gradients, the global
gradient norm (before clipping), one optimizer update and the metrics.

A mixture-of-experts transformer adds its pre-weighted balance loss
(``Octo.moe_aux_loss``, the JAX step's ``'losses'`` collection) to each
loss before the gradients, without reading it back to the host.

With ``accum_steps`` > 1 the batch splits into that many microbatches
(microbatch k is rows ``[k B/A, (k+1) B/A)``, the JAX step's reshape),
each with fresh draws from the generators; their gradients are summed in
float32, averaged and cast to the parameter dtype, and the loss averaged,
before one update.

``jit=True`` (the default, as in the JAX package) compiles the step for a
state on the card: the first call runs eagerly on a side stream (warm-up:
kernel libraries load, flash tables and caches are built, cuBLAS picks its
algorithms), then one whole step (forward, ``torch.autograd.grad``, global
norm, optimizer, EMA, metrics, every microbatch) is captured as a
``torch.cuda.CUDAGraph``, which every later call replays after copying its
batch into the graph's input buffers.  The state's generators are
registered with the graph, so each replay draws fresh numbers, the same
ones the eager step would draw; with ``cfg.remat`` the recomputes draw
from spare generators set before each replay (``core.replay.
RecomputePlan``).  A state on the CPU runs eagerly.

With a ``mesh`` (``parallel.mesh.make_mesh``) the step is data parallel:
each rank is handed its rows of the global batch (``parallel.mesh.
data_slice``) and runs under ``core.global_batch.data_parallel``, so
its draws (patch positions, dropout masks, the diffusion head's times and
noise) are made for the global batch and cut to its rows, the flash
kernels' in-kernel attention dropout counts the rank's rows from its
first global row (``row_offset``), and the MoE balance loss's statistics
are taken over the global batch; the loss and the gradients are averaged
over the ``data`` axis before the update.  A step on P ranks so draws
what a one-device step draws.  With ``accum_steps`` > 1 a rank is handed
its rows of each global microbatch, microbatch after microbatch
(``data_slice(..., microbatches=accum_steps)``), so that its microbatch k
is its rows of global microbatch k, its draws made for that microbatch.
At a data size of one no collective runs.

A model sharded by ``parallel.mesh.shard_params`` trains through the same
step, as in the JAX package (``core.tensor_parallel``): the split layers
compute on their shards and sum or gather over ``model`` inside the
forward and backward; the gradients are taken on each rank's shards (a
DTensor parameter's gradient is its local shard) and ``reduce_grads``
averages over ``data`` only what the shards' backward has not summed
already (an FSDP parameter's gradient comes back reduce-scattered over
``data``; it is only divided).  The global norm sums the local squares
and all-reduces them, each element counted once (``optim.global_norm``),
and the optimizer updates the local shards.  The loss and the grad norm
come out as on one device.  A CUDA graph does not hold the collectives:
on the card, ``jit=True`` under a mesh of more than one rank (on either
axis) raises; at a mesh of one rank nothing is sharded and the step is
captured as without a mesh.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Mapping, Optional

import torch

from ..core.global_batch import all_reduce_sum, data_parallel
from ..core.replay import RecomputePlan
from ..core.tensor_parallel import local, sharded_over
from ..parallel.mesh import DATA_AXIS, data_info, mesh_size
from ..utils.debug import jit_enabled
from .optim import global_norm, shard_replicas
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


def _signature(tensors: List[torch.Tensor]):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class CapturedStep:
    """A step function compiled as a CUDA graph per (state, input shapes).

    ``body(state, *inputs, draws=...)`` does the device work of one call
    and returns its output tensor; it must advance nothing on the host.
    ``after(state)`` is the host bookkeeping of one call (``state.step +=
    1``), run after every eager call and every replay.  ``generators(state)``
    are registered with each graph, so that a replay advances them as the
    eager call would.  The first ``WARMUP_CALLS`` calls for a (state,
    shapes) run ``body`` eagerly on a side stream; the next captures it and
    replays it; later calls replay.  The warm-up measures and the capture
    registers what the recomputes of rematerialized blocks draw
    (``core.replay.RecomputePlan``).  A call with explicit ``draws`` runs
    eagerly, as does every call while ``utils.debug`` runs the compiled
    paths eagerly.  A failed capture raises.  A state restored since its
    capture (``state.restored`` changed) is captured anew; a ``Metrics``
    object put in place of the captured one (``fit`` does so after each
    log) is adopted: its values move into the graph's accumulators, which
    it then holds."""

    # eager calls of a (state, shapes) before its capture: they load the
    # kernel libraries and make every table and cache that is built at
    # first use, which a capture could not do
    WARMUP_CALLS = 1

    def __init__(self, body: Callable, after: Callable,
                 generators: Callable = lambda state: state.rngs.values()):
        self.body = body
        self.after = after
        self.generators = generators
        self._graphs = weakref.WeakKeyDictionary()   # state -> {key: entry}
        self._stream = None

    def __call__(self, state, *inputs, draws: Optional[Mapping] = None):
        device = next(state.model.parameters()).device
        if device.type != "cuda" or draws or not jit_enabled():
            # explicit draws are a hook of the parity checks, which hold
            # the eager step; a graph takes its draws from the generators.
            # utils.debug's disable_jit and NaN checks run eagerly too
            out = self.body(state, *inputs, draws=draws)
            self.after(state)
            return state, out
        tensors = [torch.as_tensor(x, device=device) for x in inputs]
        key = _signature(tensors)
        per_state = self._graphs.setdefault(state, {})
        entry = per_state.get(key)
        if entry is not None and entry["restored"] != state.restored:
            per_state.clear()
            entry = None
        if entry is None:
            entry = {"calls": 0, "restored": state.restored,
                     "plan": RecomputePlan()}
            per_state[key] = entry
        if entry["calls"] < self.WARMUP_CALLS:
            entry["calls"] += 1
            with entry["plan"].measuring(list(self.generators(state))):
                out = self._eager_on_side_stream(state, tensors)
            self.after(state)
            return state, out
        if "graph" not in entry:
            self._capture(entry, state, tensors)
        else:
            for dst, src in zip(entry["inputs"], tensors):
                dst.copy_(src)
            self._adopt_metrics(entry, state)
        entry["plan"].before_replay()
        entry["graph"].replay()
        self.after(state)
        return state, entry["output"].clone()

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _eager_on_side_stream(self, state, tensors):
        stream = self._side_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = self.body(state, *tensors)
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def _capture(self, entry, state, tensors):
        stream = self._side_stream()
        static = [t.clone() for t in tensors]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators(state):
            graph.register_generator_state(gen)
        plan = entry["plan"]
        plan.register(graph)
        # a private memory pool per graph: graphs of other shapes or states
        # replay in any order.  Only this thread is held to the capture's
        # rules: a checkpoint writer copying a snapshot to the host on a
        # stream of its own (train.checkpoint) may run through it
        with plan.capturing(), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            out = self.body(state, *static)
        entry.update(graph=graph, inputs=static, output=out,
                     metrics=state.metrics)

    @staticmethod
    def _adopt_metrics(entry, state):
        captured, now = entry["metrics"], state.metrics
        if now is captured:
            return
        if now.kinds != captured.kinds:
            raise ValueError(
                f"the state's metrics were declared anew ({sorted(now.kinds)}"
                f" after {sorted(captured.kinds)}) after the step was "
                f"captured; build a new step")
        for n in captured.kinds:
            captured.sums[n].copy_(now.sums[n])
            captured.counts[n].copy_(now.counts[n])
        now.sums, now.counts = captured.sums, captured.counts
        entry["metrics"] = now


def make_train_step(head: str, donate: bool = True, jit: bool = True,
                    accum_steps: int = 1,
                    text_input: str = "ids", mesh=None) -> Callable:
    """Build ``step(state, text, images, actions, *, draws=None) ->
    (state, loss)``; the state is updated in place and returned.

    ``jit=True`` compiles the step as a CUDA graph for a state on the card
    (see the module docstring); ``jit=False``, or a state on the CPU, runs
    it eagerly.  ``donate`` is accepted for the JAX signature and does
    nothing: the state is always updated in place, which is what donation
    buys the JAX step.
    ``draws`` optionally replaces the generators' train-mode draws:
    ``positions`` ((B, F, P) rows, cols) and, for the diffusion head,
    ``time`` (B, 1) and ``noise`` (B, A).
    ``text_input='embeddings'`` takes the frozen text tower's (B, T, E)
    output instead of ids.  ``mesh``: data-parallel over its ``data`` axis
    (see the module docstring); the step takes this rank's rows, and any
    explicit ``draws`` are cut as the batch is.  A model sharded on the
    mesh (``shard_params``) trains on its shards."""
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
    group = mesh.get_group(DATA_AXIS) if mesh is not None else None
    data_size = data_info(mesh)[1]

    def body(state: OctoTrainState, text, images, actions, *,
             draws: Optional[Mapping] = None):
        with data_parallel(group):
            return _body(state, text, images, actions, draws)

    def reduce_grads(grads, params):
        """The average over the data axis (nothing at one rank): summed
        over it, unless the parameter is split over ``data`` (its gather's
        backward summed it already), and divided by its size."""
        if data_size == 1:
            return grads
        inv = 1.0 / data_size
        return {n: None if g is None else
                (g if sharded_over(params[n], DATA_AXIS)
                 else all_reduce_sum(g, group)) * inv
                for n, g in grads.items()}

    def _body(state: OctoTrainState, text, images, actions, draws):
        model = state.model
        loss_fn = getattr(model, method)

        def with_aux(per_example):
            # the mean loss plus the pre-weighted auxiliary term the forward
            # handed back (the MoE balance loss; none for a dense MLP)
            aux = model.moe_aux_loss()
            loss = per_example.mean()
            return loss if aux is None else loss + aux
        names = [n for n, p in state.params.items() if p.requires_grad]
        params = [state.params[n] for n in names]
        b = actions.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps={accum_steps}")
        # a sharded parameter's gradient: this rank's shard of it
        grad = lambda l: [None if g is None else local(g) for g in
                          torch.autograd.grad(l, params, allow_unused=True)]
        if accum_steps == 1:
            loss = with_aux(loss_fn(text, images, actions, True,
                                    rngs=state.rngs, **(draws or {})))
            grads = grad(loss)
        else:
            loss = torch.zeros((), device=actions.device)
            sums = [None] * len(params)
            for i in range(accum_steps):
                mb = lambda x: x.chunk(accum_steps)[i]
                l_i = with_aux(loss_fn(
                    mb(text), mb(images), mb(actions), True, rngs=state.rngs,
                    **_split_draws(draws, i, accum_steps)))
                g_i = grad(l_i)
                loss = loss + l_i.detach()
                sums = [s if g is None else
                        (g.float() if s is None else s + g.float())
                        for s, g in zip(sums, g_i)]
            inv = 1.0 / accum_steps
            loss = loss * inv
            grads = [None if s is None else (s * inv).to(p.dtype)
                     for s, p in zip(sums, params)]
        grads = reduce_grads(dict(zip(names, grads)), state.params)
        if data_size > 1:
            loss = all_reduce_sum(loss.detach(), group) * (1.0 / data_size)
        present = [n for n, g in grads.items() if g is not None]
        grad_norm = (
            global_norm([grads[n] for n in present],
                        shard_replicas([state.params[n] for n in present]))
            if present else torch.zeros((), device=actions.device))
        state.update_parameters(grads)
        loss = loss.detach()
        std = {k: v for k, v in (("loss", loss), ("grad_norm", grad_norm))
               if k in state.metrics.sums}
        state.metrics.update(**std)
        return loss

    def after(state: OctoTrainState):
        state.step += 1

    if jit:
        captured = CapturedStep(body, after)
        ranks = mesh_size(mesh)
        if ranks == 1:
            return captured

        def guarded(state, *inputs, draws=None):
            if next(state.model.parameters()).device.type == "cuda":
                raise ValueError(
                    f"make_train_step(jit=True) under a mesh of {ranks} "
                    f"ranks ({dict(zip(mesh.mesh_dim_names, mesh.shape))}): "
                    f"the CUDA graph would not hold the collectives; pass "
                    f"jit=False")
            return captured(state, *inputs, draws=draws)
        return guarded

    def step(state: OctoTrainState, text, images, actions, *,
             draws: Optional[Mapping] = None):
        loss = body(state, text, images, actions, draws=draws)
        after(state)
        return state, loss

    return step
