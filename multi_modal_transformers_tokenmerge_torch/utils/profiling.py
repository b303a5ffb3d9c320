"""Profiling and timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome / Perfetto trace (``trace.json``) into ``logdir``; it records the
  host, and the card when one is present.
* :func:`time_fn`: steady-state latency of a call: untimed warm-up calls,
  then timed calls that each end when the device work of the output is
  done (``torch.cuda.synchronize()`` on every card an output tensor lies
  on, where the JAX version blocks until ready); percentiles in seconds.

The profiler on an H100 was seen to lose the device records of a session's
first kernels (``chip_smoke.py:profiled``); a trace taken for kernel times
should warm up before it, or use ``chip_smoke.py:profile_session``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["trace", "time_fn"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block into ``logdir/trace.json`` (viewable
    in Perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _devices(x, out):
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _devices(v, out)
    return out


def _block(x):
    """Wait for the device work of every CUDA tensor in ``x``."""
    for device in _devices(x, set()):
        torch.cuda.synchronize(device)
    return x


def time_fn(fn: Callable, *args, iters: int = 30, warmup: int = 3,
            **kwargs) -> Dict[str, float]:
    """Measure steady-state latency of ``fn(*args, **kwargs)``.

    Runs ``warmup`` untimed calls (kernel builds, caches, graph capture),
    then ``iters`` timed calls, each ending in a synchronize of the
    output's devices.  Returns seconds: p50/p90/p99/mean, and ``iters``."""
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)
    s = np.asarray(samples)
    return {
        "p50": float(np.percentile(s, 50)),
        "p90": float(np.percentile(s, 90)),
        "p99": float(np.percentile(s, 99)),
        "mean": float(s.mean()),
        "iters": iters,
    }
