"""Debug and sanitizer switches.

Counterpart of the JAX package's ``utils/debug.py``.  Two switches and a
host-side check:

* **NaN checks** (``jax_debug_nans``): a ``TorchDispatchMode`` that raises
  ``FloatingPointError`` at the first operator whose floating-point output
  holds a NaN, naming the operator.  Allocators (``empty`` and its kin,
  whose output holds whatever the memory held) and the lifts of a caller's
  constants are not checked.  Dispatch modes live on the thread that enters
  them: the checks see the operators of that thread, and of autograd's
  backward, which inherits the mode.  A hand-written kernel's launch is no
  operator; its NaN shows at the first operator that reads its output.
* **Eager compiled paths** (``jax_disable_jit``): ``PolicyEngine.compile``
  and ``make_train_step(jit=True)`` capture CUDA graphs; with this switch on
  they capture nothing and every call runs eagerly (on the engine's serving
  copy, or the step's own body).  A NaN check reads each output back to
  the host, which a capture cannot do, so with NaN checks on the compiled
  paths run eagerly too, much as JAX reruns a jitted function op by op
  when it finds a NaN.  Both are off unless the caller turns them on.
* :func:`assert_finite`: counts the NaNs and infs of every leaf of a nested
  dict, list, ``state_dict()`` or module.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["enable_debug_checks", "debug_mode", "assert_finite",
           "jit_enabled", "nan_checks_enabled"]

# allocators, whose output is uninitialized memory, and the lifts that turn
# a caller's tensor constant into an operand (JAX checks no device_put)
_UNCHECKED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_", "set_", "lift",
                        "lift_fresh", "lift_fresh_copy"})

_STATE = {"nans": None, "disable_jit": False}   # nans: the active mode


class _NanCheckMode(TorchDispatchMode):
    """Raises FloatingPointError on the first floating operator output
    holding a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNCHECKED:
            leaves, _ = tree_flatten(out)
            for t in leaves:
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.device.type != "meta"
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


def nan_checks_enabled() -> bool:
    return _STATE["nans"] is not None


def jit_enabled() -> bool:
    """True unless ``disable_jit`` or the NaN checks are on: whether the
    compiled paths may capture and replay CUDA graphs."""
    return not (_STATE["disable_jit"] or nan_checks_enabled())


def _set_nans(on: bool) -> None:
    if on and _STATE["nans"] is None:
        mode = _NanCheckMode()
        mode.__enter__()
        _STATE["nans"] = mode
    elif not on and _STATE["nans"] is not None:
        mode, _STATE["nans"] = _STATE["nans"], None
        mode.__exit__(None, None, None)


def enable_debug_checks(nans: bool = True, disable_jit: bool = False):
    """Turn on global debug checks: NaN detection in every operator result
    (``nans=False`` turns it off) and, optionally, eager compiled paths."""
    _set_nans(nans)
    if disable_jit:
        _STATE["disable_jit"] = True


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = True):
    """Scoped debug mode: NaN checks and eager compiled paths; the previous
    state returns on exit."""
    prev_nans = nan_checks_enabled()
    prev_jit = _STATE["disable_jit"]
    try:
        _set_nans(nans)
        _STATE["disable_jit"] = disable_jit
        yield
    finally:
        _set_nans(prev_nans)
        _STATE["disable_jit"] = prev_jit


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "tree"):
    """Host-side finiteness check over a nested dict / list, a
    ``state_dict()`` or a module (eager contexts only).  Raises
    FloatingPointError naming the first leaf with a NaN or an inf and
    counting both."""
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.is_floating_point() or leaf.is_complex():
                leaf = leaf.to(torch.float64 if leaf.is_floating_point()
                               else torch.complex128)
            arr = leaf.cpu().numpy()
        else:
            arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}{key}: "
                f"nan={np.isnan(arr).sum()}, inf={np.isinf(arr).sum()}")
