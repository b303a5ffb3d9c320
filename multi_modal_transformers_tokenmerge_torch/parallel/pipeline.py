"""GPipe pipeline parallelism over a stack of encoder blocks.

Counterpart of the JAX package's ``parallel/pipeline.py``.  The blocks of a
stack are split into P stages; M microbatches stream through them in
M + P - 1 ticks: at tick t stage 0 takes microbatch t, every stage runs its
blocks on what it holds, the last stage finishes microbatch t - (P - 1),
and every stage hands its result to the next over the ring
(:class:`~.distributed.Ring`: point-to-point sends between ranks, or a
:class:`~.distributed.LocalRing` of P stages in one process).  At the end
the last stage's outputs go to every stage.  Differentiable: the backward
runs the schedule in reverse, each stage recomputing its blocks on the
input it saved (GPipe's rematerialization) and sending its input's
gradient back one stage, so each stage's blocks get their gradients where
they live.  The recompute draws what the forward drew: the states of the
generators the blocks draw from (``generators``) are saved before each
stage's forward at each tick and put back for its recompute
(``core.replay.replayed``).

With a data axis (PP x DP) each data rank runs its rows of every
microbatch, and the output is gathered over the data axis into the global
(B, ...) output that every rank returns, as the JAX function returns it
(sharded over the data axis there); the gather's backward hands each rank
the gradient of its own rows.

A stage computes only on ticks where it holds a microbatch (the JAX scan
computes on every tick and drops the bubble's results), which changes no
result.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..core.replay import replayed
from .distributed import Ring
from .ring_attention import ring_of

__all__ = ["split_stages", "pipelined_apply", "PIPE_AXIS"]

PIPE_AXIS = "pipe"


def split_stages(blocks: Sequence[nn.Module],
                 num_stages: int) -> List[List[nn.Module]]:
    """The blocks of a stack (e.g. ``TransformerStack.blocks``) as
    ``num_stages`` consecutive stages of equal length."""
    blocks = list(blocks)
    if len(blocks) % num_stages:
        raise ValueError(f"{len(blocks)} layers not divisible by "
                         f"{num_stages} pipeline stages")
    n = len(blocks) // num_stages
    return [blocks[i * n:(i + 1) * n] for i in range(num_stages)]


def pipelined_apply(layer_fn: Callable, stage_params: Sequence[Sequence],
                    x: torch.Tensor, group_or_mesh, num_microbatches: int,
                    axis: str = PIPE_AXIS,
                    data_axis: Optional[str] = None,
                    generators: Sequence[torch.Generator] = ()
                    ) -> torch.Tensor:
    """Run ``x`` through every stage.

    ``layer_fn(block, h) -> h`` applies one block (e.g. an ``EncoderBlock``
    with its mask closed over).  ``stage_params``: :func:`split_stages`'s
    list; a process runs the stages its ring holds (all of them for a
    :class:`LocalRing`, the rank's for a group or a mesh's ``axis``).
    ``x`` (B, ...) is the global batch on every process; B must divide by
    ``num_microbatches`` (times the data size with ``data_axis``).
    ``generators``: every generator ``layer_fn`` draws from (the
    'dropout' generator of an ``EncoderBlock`` in train mode).  The
    backward recomputes each stage from their states saved at its
    forward, so it draws the same masks; a generator drawn from and not
    listed would give the recompute other masks, and the gradients of
    another function than the one run forward.

    Returns the (B, ...) outputs on every stage.  With ``data_axis`` (PP x
    DP over a mesh) each rank runs its rows of every microbatch, and the
    output is gathered over the data axis: every rank returns the global
    (B, ...) output; a loss taken on it by every rank gives each rank the
    gradient of its own rows, and the blocks' gradients are those rows'
    share, to be summed over the data axis."""
    ring: Ring = ring_of(group_or_mesh, axis)
    p = ring.size
    if len(stage_params) != p:
        raise ValueError(f"{len(stage_params)} stages for a pipeline of {p}")
    b = x.shape[0]
    m = num_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by M={m}")
    mbs = list(x.chunk(m))
    group = None
    if data_axis is not None:
        from .mesh import data_slice
        mesh = group_or_mesh
        if not hasattr(mesh, "mesh_dim_names") or \
                data_axis not in mesh.mesh_dim_names:
            raise ValueError(f"data_axis {data_axis!r} needs a mesh that "
                             f"has it")
        d = mesh.size(mesh.mesh_dim_names.index(data_axis))
        if (b // m) % d:
            raise ValueError(f"microbatch size {b // m} not divisible by "
                             f"the data axis ({d})")
        mbs = [data_slice(mb, mesh, axis=data_axis) for mb in mbs]
        group = mesh.get_group(data_axis) if d > 1 else None
    # each process hands the autograd function the parameters of the stages
    # it holds, so their gradients come back through its backward
    params = [list(_stage_parameters(stage_params[i])) for i in ring.indices]
    flat = [t for ps in params for t in ps]
    out = _GPipe.apply(ring, layer_fn, stage_params, m, tuple(generators),
                       torch.stack(mbs), len(flat), *flat)
    return out if group is None else _GatherRows.apply(out, group, m)


class _GatherRows(torch.autograd.Function):
    """A data rank's rows of each of M microbatches, (M * b, ...), as the
    global (M * b * D, ...) output, microbatch k being the D ranks' rows of
    it in rank order (the JAX output's layout).  Backward: each rank takes
    the gradient of its own rows (every rank holds the whole output's
    gradient, taken on the same global loss)."""

    @staticmethod
    def forward(ctx, rows, group, m):
        d = dist.get_world_size(group)
        parts = [torch.empty_like(rows) for _ in range(d)]
        dist.all_gather(parts, rows.contiguous(), group=group)
        ctx.rank, ctx.m, ctx.d = dist.get_rank(group), m, d
        b = rows.shape[0] // m
        per_mb = [p.reshape(m, b, *rows.shape[1:]) for p in parts]
        return torch.cat(per_mb, dim=1).reshape(m * b * d, *rows.shape[1:])

    @staticmethod
    def backward(ctx, g):
        m, d = ctx.m, ctx.d
        b = g.shape[0] // (m * d)
        mine = g.reshape(m, d, b, *g.shape[1:])[:, ctx.rank]
        return mine.reshape(m * b, *g.shape[1:]), None, None


def _stage_parameters(stage):
    for block in stage:
        yield from (p for p in block.parameters() if p.requires_grad)


def _stage_fn(layer_fn, stage, h):
    for block in stage:
        h = layer_fn(block, h)
    return h


class _GPipe(torch.autograd.Function):
    """The schedule's forward without autograd (saving each stage's input
    and the generators' states at each tick), and its backward by hand in
    the reverse tick order: a stage recomputes its blocks on the saved
    input and states (GPipe's rematerialization), takes the gradients of
    its blocks and of its input for the gradient of its output, and the
    input's gradient goes back one stage over the ring.  Every process
    takes part in every exchange, in the same order, so the point-to-point
    sends pair up."""

    @staticmethod
    def forward(ctx, ring, layer_fn, stages, m, generators, mbs, n_params,
                *params):
        p = ring.size
        zeros = torch.zeros_like(mbs[0])
        state = {i: zeros for i in ring.indices}
        saved = {i: {} for i in ring.indices}
        outputs = [zeros] * m
        for t in range(m + p - 1):
            if 0 in state:
                state[0] = mbs[min(t, m - 1)]
            out = []
            for i in ring.indices:
                live = 0 <= t - i < m      # stage i holds microbatch t - i
                if live:
                    saved[i][t] = (state[i],
                                   [g.get_state() for g in generators])
                out.append((_stage_fn(layer_fn, stages[i], state[i])
                            if live else zeros,))
            if p - 1 in ring.indices and t >= p - 1:
                outputs[t - (p - 1)] = out[ring.indices.index(p - 1)][0]
            if t + 1 < m + p - 1:
                state = {i: s[0] for i, s in zip(ring.indices,
                                                 ring.shift(out))}
        done = torch.cat(outputs)
        ctx.ring, ctx.layer_fn, ctx.stages, ctx.m = ring, layer_fn, stages, m
        ctx.generators = generators
        ctx.saved, ctx.mb_shape = saved, mbs.shape
        return ring.sum_to_all([done] * len(ring.indices), p - 1)

    @staticmethod
    def backward(ctx, g):
        ring, m = ctx.ring, ctx.m
        p = ring.size
        g_mbs = list(g.chunk(m))
        zeros = torch.zeros(ctx.mb_shape[1:], dtype=g.dtype, device=g.device)
        d_mbs = [torch.zeros_like(zeros) for _ in range(m)]
        held = ring.indices
        params = {i: list(_stage_parameters(ctx.stages[i])) for i in held}
        d_params = {i: [None] * len(params[i]) for i in held}
        # the gradient of each held stage's output at the current tick
        d_out = {i: zeros for i in held}
        for t in reversed(range(m + p - 1)):
            if p - 1 in held and t >= p - 1:
                d_out[p - 1] = g_mbs[t - (p - 1)]
            d_in = []
            for i in held:
                if t not in ctx.saved[i]:
                    d_in.append((zeros,))
                    continue
                h, states = ctx.saved[i][t]
                with torch.enable_grad(), replayed(ctx.generators, states):
                    h = h.detach().requires_grad_(True)
                    out = _stage_fn(ctx.layer_fn, ctx.stages[i], h)
                    grads = torch.autograd.grad(out, [h] + params[i],
                                                d_out[i], allow_unused=True)
                d_params[i] = [a if b is None else (b if a is None else a + b)
                               for a, b in zip(d_params[i], grads[1:])]
                if i == 0:
                    d_mbs[min(t, m - 1)] = d_mbs[min(t, m - 1)] + grads[0]
                    d_in.append((zeros,))
                else:
                    d_in.append((grads[0],))
            if t > 0:
                # stage i's input came from stage i - 1 at tick t - 1
                back = ring.shift(d_in, direction=-1)
                d_out = {i: s[0] for i, s in zip(held, back)}
        flat = [d if d is not None else torch.zeros_like(q)
                for i in held for d, q in zip(d_params[i], params[i])]
        return (None, None, None, None, None, torch.stack(d_mbs), None,
                *flat)
