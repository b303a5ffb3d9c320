"""The shards of a sharded model, seen from the layers that compute on
them and from the optimizer that updates them.

``parallel.mesh.shard_params`` stores every parameter that the JAX rules
shard as a DTensor on the ``(data, model)`` mesh.  What is split:

* parameters sharded over ``model`` (the Megatron pairs of attention and
  MLP, the expert stacks) are read as the rank's local shard
  (:func:`local`), and the layers split their products, as XLA does for
  the JAX package: a column-parallel product (its weight's output rows
  split) takes the replicated input through :func:`to_model` (identity;
  its gradient is summed over the model axis, Megatron's ``f``) and gives
  the rank's columns; a row-parallel one (input columns split) sums its
  partial products with :func:`from_model` (an all-reduce whose gradient
  passes unchanged, Megatron's ``g``) and adds its bias once.  An
  attention core on heads ``[h0, h0 + H)`` of ``H_total`` runs inside
  :func:`head_slice`: the flash kernels' dropout counter takes ``h0`` and
  ``H_total`` (:func:`head_offset`), and dropout masks drawn in torch are
  drawn for every head and cut to the rank's (:func:`draw_cut`), as
  ``global_batch.draw_global`` does for rows;
* parameters sharded over ``data`` (FSDP) are gathered where they are
  used and their gradients come back reduce-scattered over ``data``
  (``parallel.mesh``).

The optimizer and the step work on local shards: :func:`replicas` says on
how many ranks the same elements of a tensor live, so that a norm summed
over the world counts each element once.  Names of parameters behind a
gathering parametrization are read without it (:func:`param_name`).

It lives here, below ``ops`` and ``modules``, so that they need nothing
of ``parallel``.  Nothing here runs for a model that ``shard_params`` left
whole: every helper returns its input unchanged.
"""

from __future__ import annotations

import contextlib
import re
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Split", "local", "model_split",
           "sharded_over", "to_model", "from_model", "gather_model",
           "head_slice", "head_offset", "draw_cut", "replicas",
           "copy_into", "param_name", "named_params"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Split(NamedTuple):
    """A tensor's split over the model axis: the tensor dim cut, the model
    group, this rank's index on it and its size."""
    dim: int
    group: object
    rank: int
    size: int


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (differentiably: its gradient
    returns with the DTensor's placements), else ``t``."""
    return t.to_local() if hasattr(t, "placements") else t


def sharded_over(t: torch.Tensor, axis: str) -> bool:
    """Whether the DTensor ``t`` is split over the mesh axis ``axis`` (of
    more than one rank); False for a plain tensor."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return False
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return False
    i = names.index(axis)
    return placements[i].is_shard() and mesh.size(i) > 1


def model_split(t: torch.Tensor) -> Optional[Split]:
    """The :class:`Split` of a DTensor sharded over ``model``, else
    None."""
    if not sharded_over(t, MODEL_AXIS):
        return None
    mesh = t.device_mesh
    i = mesh.mesh_dim_names.index(MODEL_AXIS)
    return Split(t.placements[i].dim, mesh.get_group(MODEL_AXIS),
                 mesh.get_local_rank(MODEL_AXIS), mesh.size(i))


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.rank, ctx.dim, ctx.n = rank, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


def to_model(x: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """A replicated ``x`` entering a split product: ``x`` itself, its
    gradient summed over the model axis (each rank's product sees only its
    shard's share of it)."""
    return x if split is None else _ToModel.apply(x, split.group)


def from_model(x: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """The sum over the model axis of each rank's partial ``x``: the
    replicated result of a row-parallel product; its gradient passes to
    every rank unchanged."""
    return x if split is None else _FromModel.apply(x, split.group)


def gather_model(x: torch.Tensor, split: Optional[Split],
                 dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    column-parallel output made whole); the gradient keeps this rank's
    part."""
    if split is None:
        return x
    return _GatherModel.apply(x, split.group, split.rank, split.size,
                              dim % x.dim())


_HEADS: List[Tuple[int, int]] = []


@contextlib.contextmanager
def head_slice(h0: int, heads_total: int):
    """Within the block an attention core holds heads ``[h0, h0 + H)`` of
    ``heads_total``: its dropout draws are those of those heads."""
    _HEADS.append((h0, heads_total))
    try:
        yield
    finally:
        _HEADS.pop()


def head_offset(heads: int) -> Tuple[int, int]:
    """(first head, total heads) of an attention core over ``heads`` heads:
    the innermost :func:`head_slice`, or (0, heads) outside one."""
    return _HEADS[-1] if _HEADS else (0, heads)


def draw_cut(draw, shape, dim: int, offset: int, total: int):
    """``draw(shape)``, or where ``shape[dim]`` is a cut of ``total``
    starting at ``offset``: ``draw`` of the whole shape, cut to it."""
    shape = tuple(shape)
    n = shape[dim]
    if n == total:
        return draw(shape)
    full = draw(shape[:dim] + (total,) + shape[dim + 1:])
    return full.narrow(dim, offset, n)


def replicas(t: torch.Tensor) -> int:
    """On how many ranks of the world the same elements of ``t`` live:
    the world size over the sizes of the mesh axes that split a DTensor
    (every rank holds a plain tensor whole)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    placements = getattr(t, "placements", None)
    if placements is None:
        return world
    mesh = t.device_mesh
    split = 1
    for i, p in enumerate(placements):
        if p.is_shard():
            split *= mesh.size(i)
    return world // split


@torch.no_grad()
def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` in place, whatever the layout of either:
    a whole tensor into a DTensor's shard (cut as its placements cut),
    a DTensor of another layout gathered first."""
    if hasattr(src, "placements"):
        if (hasattr(dst, "placements")
                and tuple(src.placements) == tuple(dst.placements)):
            dst.to_local().copy_(src.to_local())
            return
        src = src.full_tensor()
    if hasattr(dst, "placements"):
        mesh = dst.device_mesh
        for i, p in enumerate(dst.placements):
            if p.is_shard():
                src = src.chunk(mesh.size(i), dim=p.dim)[
                    mesh.get_coordinate()[i]]
    local(dst).copy_(src)


_PARAMETRIZED = re.compile(r"(^|\.)parametrizations\.([^.]+)\.original$")


def param_name(name: str) -> str:
    """A parameter's name without a parametrization's path
    (``a.parametrizations.w.original`` -> ``a.w``)."""
    return _PARAMETRIZED.sub(r"\1\2", name)


def named_params(model: torch.nn.Module):
    """``model.named_parameters()`` under :func:`param_name`'s names."""
    return [(param_name(n), p) for n, p in model.named_parameters()]
