"""Process groups, and the collectives the parallel paths run over them.

Counterpart of the JAX package's ``parallel/distributed.py``.  There one
controller drives every chip and ``jax.distributed.initialize`` joins the
hosts; here every device has a process of its own, joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU).

Beside the initialisation this module holds the rings the parallel paths
share:

* :class:`Ring`: the P shards of a ring (ring attention's sequence shards,
  the pipeline's stages).  A ring over a process group holds one shard,
  the rank's, and its :meth:`Ring.shift` sends to rank + 1 and receives
  from rank - 1 (``batch_isend_irecv``), differentiably.  :class:`LocalRing`
  holds all P shards in one process and shifts by rotating a list: the
  counterpart of the JAX tests' virtual devices, which the CPU tests and a
  one-card machine use.  The compute code is written once, over the shards
  a ring holds.

The data-parallel context that the ops and modules read (the global
batch's draws and sums) is ``core.global_batch``'s, below them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "process_info", "Ring",
           "LocalRing", "GroupRing", "ensure_world"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join this process to the others: ``init_process_group`` on NCCL
    when a card is present, else gloo.

    ``coordinator_address`` is an init method (``tcp://host:port`` or
    ``file:///path``); with no arguments torchrun's environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) is read.  A no-op when the
    group is already initialised or when nothing says there is more than
    one process, as the JAX function is."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
            return
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        coordinator_address = "env://"
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs num_processes and "
                         "process_id beside the coordinator address")
    if coordinator_address and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend or _default_backend(),
                            init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def ensure_world(backend: Optional[str] = None) -> None:
    """A process group of one when none is initialised (a single process
    that asks for a mesh), on an in-memory store."""
    if not dist.is_initialized():
        dist.init_process_group(backend or _default_backend(),
                                store=dist.HashStore(), world_size=1, rank=0)


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """The JAX function's keys: one device a process here."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_device_count": local,
        "global_device_count": world,
    }


# -- rings -------------------------------------------------------------------------

class Ring:
    """P shards in a ring; ``indices`` are the ones this process holds."""

    size: int
    indices: Sequence[int]

    def shift(self, shards: List[tuple], direction: int = 1) -> List[tuple]:
        """Shard i's tuple of tensors moves to shard i + direction (mod P),
        ``direction`` being 1 or -1: the result's entry for each held
        shard is what shard - direction held."""
        raise NotImplementedError

    def split(self, x: torch.Tensor, dim: int = 1) -> List[torch.Tensor]:
        """This process's part of x, split into the held shards."""
        raise NotImplementedError

    def join(self, parts: List[torch.Tensor], dim: int = 1) -> torch.Tensor:
        raise NotImplementedError

    def sum_to_all(self, parts: List[torch.Tensor],
                   src: int) -> torch.Tensor:
        """Shard ``src``'s tensor, handed to every shard (every held shard
        passes a tensor; the others' are ignored).  Differentiable: the
        gradient goes to ``src`` alone."""
        raise NotImplementedError


class LocalRing(Ring):
    """All P shards in this process; shifting rotates a list."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size {size} < 1")
        self.size = size
        self.indices = list(range(size))

    def shift(self, shards, direction=1):
        return [shards[(i - direction) % self.size]
                for i in range(self.size)]

    def split(self, x, dim=1):
        return list(x.chunk(self.size, dim=dim))

    def join(self, parts, dim=1):
        return torch.cat(parts, dim=dim)

    def sum_to_all(self, parts, src):
        return parts[src]


class _Shift(torch.autograd.Function):
    """Send to rank + direction and receive from rank - direction; the
    backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, ring, direction, *tensors):
        ctx.ring, ctx.direction = ring, direction
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(ring._exchange(tensors, direction))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g if g is not None else torch.zeros(shape, dtype=dtype,
                                                      device=device)
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, None, *ctx.ring._exchange(grads, -ctx.direction))


class _FromSource(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, is_src):
        ctx.is_src = is_src
        y = x.clone() if is_src else torch.zeros_like(x)
        dist.all_reduce(y, group=ring.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None


class GroupRing(Ring):
    """One shard a rank of ``group``, the rank's own."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.indices = [self.rank]

    def _peer(self, step: int) -> int:
        r = (self.rank + step) % self.size
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)

    def _exchange(self, tensors, direction: int):
        if self.size == 1:
            return [t for t in tensors]
        outs, ops = [], []
        for t in tensors:
            t = t.contiguous() if t is not None else t
            recv = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self._peer(direction),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(-direction),
                                  self.group))
            outs.append(recv)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def shift(self, shards, direction=1):
        (tensors,) = shards
        if self.size == 1:
            return [tensors]
        if any(t.requires_grad for t in tensors) and \
                torch.is_grad_enabled():
            return [_Shift.apply(self, direction, *tensors)]
        return [tuple(self._exchange(tensors, direction))]

    def split(self, x, dim=1):
        return [x]

    def join(self, parts, dim=1):
        return parts[0]

    def sum_to_all(self, parts, src):
        if self.size == 1:
            return parts[0]
        return _FromSource.apply(parts[0], self, self.rank == src)
