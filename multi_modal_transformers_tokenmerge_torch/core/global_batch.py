"""The global batch of a data-parallel step, seen from the layers that
draw or reduce over it.

A data-parallel step (``train.steps.make_train_step(mesh=)``,
``train.loop.evaluate(mesh=)``, ``serve.policy.PolicyEngine(mesh=)``) runs
on each rank over the rank's rows of the global batch, inside
:func:`data_parallel`.  Within it the ops and modules below the step take
what the one-device step takes over the whole batch:

* every draw of a batch-leading tensor (dropout masks, patch positions,
  diffusion times and noise, router noise) goes through
  :func:`draw_global`: made for the global batch and cut to the rank's
  rows, so a step on P ranks draws what a one-device step draws.  Each
  rank thus draws P times what it keeps (ROADMAP queue 1b);
* ``modules.moe`` takes its balance statistics over the global batch with
  :func:`all_reduce_sum`;
* the flash kernels' in-kernel attention dropout, whose Philox counter
  takes a row's index in the batch, offsets it by :func:`row_offset`, the
  rank's first row of the global batch.

A step that accumulates over microbatches under a mesh is handed each
rank's rows of every global microbatch (``parallel.mesh.data_slice(...,
microbatches=)``), so that the draws and the offset above, taken per
microbatch, are those of the one-device step's microbatch k.

It lives here, below ``ops`` and ``modules``, so that they need nothing of
``parallel``; the process groups themselves are ``parallel.distributed``'s.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "data_parallel", "data_group", "draw_global",
           "row_offset"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``; differentiable (the backward sums
    the incoming gradients, so that each rank's share of a statistic taken
    over every rank gets the whole gradient).  ``x`` itself at world 1."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


_DATA_GROUP: List = []


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, draws and statistics that a step takes over its
    batch are taken over the batch of every rank of ``group``."""
    _DATA_GROUP.append(group)
    try:
        yield
    finally:
        _DATA_GROUP.pop()


def data_group():
    """The group of the innermost :func:`data_parallel` block, or None."""
    return _DATA_GROUP[-1] if _DATA_GROUP else None


def draw_global(draw, shape, dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, or inside :func:`data_parallel` over more than one
    rank, ``draw`` of the global shape (``shape[dim]`` times the group's
    size) cut to this rank's rows along ``dim``."""
    group = data_group()
    size = 1 if group is None else dist.get_world_size(group)
    if size == 1:
        return draw(tuple(shape))
    shape = tuple(shape)
    n = shape[dim]
    full = draw(shape[:dim] + (n * size,) + shape[dim + 1:])
    return full.narrow(dim, dist.get_rank(group) * n, n)


def row_offset(rows: int) -> int:
    """The first row, in the global batch, of this rank's ``rows`` rows:
    0 outside :func:`data_parallel` or at a group of one, else the rank
    times ``rows`` (every rank holds as many rows)."""
    group = data_group()
    if group is None or dist.get_world_size(group) == 1:
        return 0
    return dist.get_rank(group) * rows
