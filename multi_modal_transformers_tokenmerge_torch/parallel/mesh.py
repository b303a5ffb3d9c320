"""Device mesh and sharding rules.

Counterpart of the JAX package's ``parallel/mesh.py``: a ``(data, model)``
mesh (a ``torch.distributed.device_mesh.DeviceMesh``, one device a
process), the batch split along ``data`` and the JAX package's
tensor-parallel / FSDP rules for parameters, as DTensor placements.

* :func:`spec_for_param` applies the rules of the JAX ``_spec_for_param``
  (Megatron splits of the attention projections and the MLP, the expert
  dim of the MoE stacks, FSDP of parameters of at least 2^16 elements) to a
  port parameter: it maps the parameter to its flax leaf and layout with
  ``convert.flax_layout`` (the inverse of ``from_flax``), takes the JAX
  spec there and maps each sharded flax axis back to the port axis that
  holds it.  The JAX rules index axes from the end, so a scanned stack's
  per-layer parameters get the spec of their stacked leaf; FSDP's size
  threshold and largest-axis choice are taken on the per-layer shape (the
  port splits scanned stacks into layers), so where JAX would shard a
  stack's layer axis the port shards a per-layer axis.
* :func:`shard_params` stores each sharded parameter as a DTensor of its
  placements, and the model computes on the shards
  (``core.tensor_parallel``):

  - what is split: a parameter sharded over ``model`` is never gathered.
    The attention and MLP blocks (``modules.attention``, the per-layer
    ToMe blocks) split their products as XLA does for the JAX package:
    ``query``/``key``/``value`` and ``dense_in`` column-parallel, a rank
    computing its ``num_heads / P`` heads (the flash kernels launched on
    them, with its head offset) and its ``mlp_dim / P`` hidden columns;
    ``out`` and ``dense_out`` row-parallel, the partial products summed
    over ``model``.  The MoE blocks run their ``E / P`` experts and sum the
    combined outputs over ``model``.  A lone ``Dense`` whose weight is
    split (the frozen T5 tower's ``o``, ``wi`` and ``wo``, a MAP head's
    projections, an MLP whose activation works over the last axis)
    computes its product split and gathers or sums its output, so that
    its caller sees the whole output;
  - what is gathered: a parameter sharded over ``data`` (FSDP) is
    all-gathered where its module reads it, through a parametrization,
    and its gradient comes back reduce-scattered over ``data`` (the
    gradient of the gather is a ``Partial`` sum over the data ranks), so
    each rank holds its rows of the data-summed gradient.

  The optimizer keeps its moments on the same shards (``train.optim``),
  and the step reduces over ``data`` only the gradients that the gather's
  backward has not (``train.steps``).
* :func:`data_slice` is a rank's share of a global batch: every rank is
  handed the global batch, as the JAX single controller is, and keeps its
  rows of the data axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.tensor_parallel import DATA_AXIS, MODEL_AXIS
from .distributed import ensure_world

__all__ = ["make_mesh", "batch_sharding", "replicated", "spec_for_param",
           "param_specs", "param_shardings", "shard_params", "data_slice",
           "data_info", "mesh_size", "DATA_AXIS", "MODEL_AXIS"]

def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: Optional[str] = None):
    """A (data, model) DeviceMesh over the process group's ranks;
    ``data=None`` takes every rank the model axis leaves.  A process with
    no group gets a world of one.  Raises when the sizes do not multiply
    to the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    ensure_world()
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} available devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _placements(mesh, spec: Tuple[Optional[str], ...]):
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for axis, name in enumerate(spec):
        if name is not None:
            out[mesh.mesh_dim_names.index(name)] = Shard(axis)
    return out


def batch_sharding(mesh):
    """Placements of a batch-leading array: rows split over ``data``."""
    return _placements(mesh, (DATA_AXIS,))


def replicated(mesh):
    return _placements(mesh, ())


def data_info(mesh, axis: str = DATA_AXIS) -> Tuple[int, int]:
    """(this rank's index on the data axis, the data axis's size); (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    if axis not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise TypeError(f"mesh must be a DeviceMesh with a {axis!r} "
                        f"axis (parallel.mesh.make_mesh); got {mesh!r}")
    return mesh.get_local_rank(axis), mesh.size(
        mesh.mesh_dim_names.index(axis))


def mesh_size(mesh) -> int:
    """The ranks of a (data, model) mesh, 1 without one; anything else
    raises as :func:`data_info` does."""
    data_info(mesh)
    return 1 if mesh is None else mesh.size()


def data_slice(x, mesh, dim: int = 0, axis: str = DATA_AXIS,
               microbatches: int = 1):
    """This rank's rows of a global batch array along ``dim`` (x itself at
    a data size of one).  With ``microbatches`` M, its rows of each of the
    M global microbatches (rows ``[k B/M, (k+1) B/M)``), microbatch after
    microbatch: what ``make_train_step(accum_steps=M, mesh=)`` takes.
    Raises when the batch does not divide."""
    rank, size = data_info(mesh, axis)
    b = x.shape[dim]
    if b % (size * microbatches):
        raise ValueError(f"batch {b} not divisible by the data axis "
                         f"({size}) times {microbatches} microbatches")
    if size == 1:
        return x
    n = b // (size * microbatches)
    if isinstance(x, torch.Tensor) and microbatches == 1:
        return x.narrow(dim, rank * n, n)
    rows = (np.arange(microbatches)[:, None] * (b // microbatches)
            + rank * n + np.arange(n)).reshape(-1)
    if isinstance(x, torch.Tensor):
        return x.index_select(dim, torch.as_tensor(rows, device=x.device))
    return np.take(np.asarray(x), rows, axis=dim)


def _jax_spec(tail: str, shape, model_parallel: bool, fsdp: bool,
              data_size: int, model_size: int, fsdp_min_size: int):
    """The JAX package's ``_spec_for_param`` on a flax leaf: ``tail`` is
    'module/leaf', ``shape`` the flax shape."""
    ndim = len(shape)
    spec = [None] * ndim
    module, leaf = tail.split("/")

    def _try(axis_from_end):
        axis = ndim - axis_from_end
        if 0 <= axis < ndim and shape[axis] % model_size == 0:
            spec[axis] = MODEL_AXIS

    if model_parallel and model_size > 1:
        if tail in ("query/kernel", "key/kernel", "value/kernel",
                    "q/kernel", "k/kernel", "v/kernel"):
            _try(2)
        elif tail in ("out/kernel", "o/kernel") and ndim >= 3:
            _try(3)
        elif tail in ("dense_in/kernel", "wi/kernel"):
            _try(1)
        elif tail in ("dense_out/kernel", "wo/kernel"):
            _try(2)
        elif leaf in ("expert_wi", "expert_wo"):
            _try(3)
        elif leaf in ("expert_bi", "expert_bo"):
            _try(2)
    if fsdp and data_size > 1 and all(s is None for s in spec):
        if np.prod(shape) >= fsdp_min_size:
            for i in sorted(range(ndim), key=lambda i: -shape[i]):
                if shape[i] % data_size == 0:
                    spec[i] = DATA_AXIS
                    break
    return spec


def _kind(module: nn.Module) -> str:
    from ..modules.image_tokenizer import PatchGroupNorm
    from ..modules.layers import Conv2d, Dense, Embed, LayerNorm
    from ..modules.moe import _Router
    from ..modules.t5 import T5RMSNorm
    if isinstance(module, (Dense, _Router)):
        return "dense"
    if isinstance(module, Conv2d):
        return "conv"
    if isinstance(module, Embed):
        return "embed"
    if isinstance(module, (LayerNorm, T5RMSNorm, PatchGroupNorm)):
        return "norm"
    return ""


def spec_for_param(name: str, param: torch.Tensor, module: nn.Module,
                   parent: Optional[nn.Module], data_size: int,
                   model_size: int, model_parallel: bool = True,
                   fsdp: bool = False, fsdp_min_size: int = 2 ** 16):
    """The mesh axis name (or None) of each axis of the port parameter
    ``name`` held by ``module`` (``parent`` holds the module; its
    ``num_heads`` shapes an attention projection's flax leaf), by the JAX
    rules on its flax leaf.  Returns ``(spec, flax_tail, flax_shape,
    flax_spec)``."""
    from ..convert import flax_layout
    parts = name.split(".")
    mod_name = parts[-2] if len(parts) > 1 else ""
    heads = getattr(parent, "num_heads", None)
    leaf, fshape, axis_map = flax_layout(mod_name, parts[-1],
                                         tuple(param.shape), _kind(module),
                                         heads)
    tail = f"{mod_name}/{leaf}"
    fspec = _jax_spec(tail, fshape, model_parallel, fsdp, data_size,
                      model_size, fsdp_min_size)
    spec = [None] * param.dim()
    for faxis, mesh_axis in enumerate(fspec):
        if mesh_axis is not None:
            spec[axis_map[faxis]] = mesh_axis
    return tuple(spec), tail, fshape, tuple(fspec)


def param_specs(model: nn.Module, data_size: int, model_size: int,
                model_parallel: bool = True, fsdp: bool = False,
                fsdp_min_size: int = 2 ** 16) -> Dict[str, tuple]:
    """name -> :func:`spec_for_param`'s spec for every parameter."""
    modules = dict(model.named_modules())
    out = {}
    for mname, module in modules.items():
        parent = modules.get(mname.rsplit(".", 1)[0] if "." in mname else "")
        for pname, p in module.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            out[full] = spec_for_param(full, p, module, parent, data_size,
                                       model_size, model_parallel, fsdp,
                                       fsdp_min_size)[0]
    return out


def param_shardings(model: nn.Module, mesh, model_parallel: bool = True,
                    fsdp: bool = False, fsdp_min_size: int = 2 ** 16):
    """name -> DTensor placements on ``mesh`` for every parameter."""
    data = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    model_size = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    specs = param_specs(model, data, model_size, model_parallel, fsdp,
                        fsdp_min_size)
    return {n: _placements(mesh, s) for n, s in specs.items()}


class _Gathered(nn.Module):
    """A parametrization that hands the module the whole parameter; the
    gradient returns as the sum over the ranks that split it, each rank
    keeping its part (a reduce-scatter)."""

    def forward(self, x):
        from torch.distributed.tensor import Partial, Replicate
        grads = [Partial() if p.is_shard() else Replicate()
                 for p in x.placements]
        return x.full_tensor(grad_placements=grads)


def shard_params(model: nn.Module, mesh, model_parallel: bool = True,
                 fsdp: bool = False, fsdp_min_size: int = 2 ** 16):
    """Store each parameter that the rules shard as a DTensor on ``mesh``
    (each rank keeps its shard).  A parameter split over ``model`` (every
    one a ``Dense`` weight or an MoE expert stack, layers that compute on
    their shards) stays split; one split over ``data`` is gathered where
    its module reads it (see the module docstring).  Replicated parameters
    stay plain tensors.  Returns ``model``."""
    from torch.distributed.tensor import distribute_tensor
    from torch.nn.utils import parametrize
    shardings = param_shardings(model, mesh, model_parallel, fsdp,
                                fsdp_min_size)
    model_dim = mesh.mesh_dim_names.index(MODEL_AXIS)
    for name, placements in shardings.items():
        if all(p.is_replicate() for p in placements):
            continue
        mod_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(mod_name)
        param = getattr(module, leaf)
        sharded = distribute_tensor(param.detach(), mesh, placements)
        with torch.no_grad():
            setattr(module, leaf, nn.Parameter(
                sharded, requires_grad=param.requires_grad))
        if not placements[model_dim].is_shard():
            parametrize.register_parametrization(module, leaf, _Gathered(),
                                                 unsafe=True)
    return model
