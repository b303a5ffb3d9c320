"""Profiling and timing utilities, and the port's tracing.

Counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome / Perfetto trace (``trace.json``) into ``logdir``; it records the
  host, and the card when one is present.
* :func:`time_fn`: steady-state latency of a call: untimed warm-up calls,
  then timed calls that each end when the device work of the output is
  done (``torch.cuda.synchronize()`` on every card an output tensor lies
  on, where the JAX version blocks until ready); percentiles in seconds.

The profiler on an H100 was seen to lose the device records of a session's
first kernels, so a trace taken for kernel times warms up first.

Tracing.  Nothing turns it on but a profiler session that records: the
operator's :func:`trace`, or any other ``torch.profiler`` session, such as
a benchmark's traced run.

* :func:`span`: a ``torch.profiler.record_function`` while a session
  records, so its records share the session's clock with the device's;
  otherwise the shared null context, at the cost of one flag check.
* :func:`section`: a model section (``model.text``, ``model.image``,
  ``model.stack``, ``model.merge``, ``model.head``; in the latent-attention
  stack also ``model.mla``, a block's attention, and ``model.moe``, a
  routed expert layer, both inside ``model.stack``).  On an eager call it
  is a :func:`span`.  While an engine captures a CUDA graph under
  :func:`node_plan` it records which graph nodes the section added: a
  replay runs none of the model's Python, so its device records are split
  by that plan and not by spans.  No node is added to the graph.
* :data:`REGISTRY`: the process-wide registry of the plans
  (:class:`NodePlan`, one per compiled path, the latest capture of each)
  and of counters (``engine.replays``, ``engine.eager_calls``: the
  engine's calls by route; ``image.norm_kernel`` / ``image.norm_plain``
  and ``moe.grouped_kernel`` / ``moe.plain``: the route each capture or
  eager call of a tower norm or a routed layer took), which per-layer
  readers import.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["trace", "time_fn", "span", "section", "node_plan",
           "capture_counter", "NodePlan", "Registry", "REGISTRY"]


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


# -- tracing ---------------------------------------------------------------

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """``record_function(name)`` while a profiler session records (``args``,
    made a string, in its arguments), else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(
            name, None if args is None else str(args))
    return _OFF


@dataclass(frozen=True)
class NodePlan:
    """The device nodes (kernels, copies, sets) of one captured graph, in
    capture order: ``entries`` holds ``(section, first node, node count)``
    for each section entered during the capture, in the order entered
    (nested sections inside their parent's range), ``total`` the graph's
    device nodes."""

    entries: Tuple[Tuple[str, int, int], ...]
    total: int

    def nodes(self, name: str) -> set:
        """Indices of the nodes that sections named ``name`` added."""
        return {i for s, first, n in self.entries if s == name
                for i in range(first, first + n)}

    def outside(self) -> int:
        """Nodes no section added."""
        inside = {i for _, first, n in self.entries
                  for i in range(first, first + n)}
        return self.total - len(inside)


@dataclass
class Registry:
    """What tracing keeps for the process: each compiled path's plan and
    the engine's call counts by route."""

    plans: Dict[str, NodePlan] = field(default_factory=dict)
    counters: collections.Counter = field(
        default_factory=collections.Counter)

    def clear(self) -> None:
        self.plans.clear()
        self.counters.clear()


REGISTRY = Registry()
_capture = threading.local()


class _PlanRecorder:
    def __init__(self, count: Callable[[], int]):
        self.count = count
        self.base = count()
        self.entries = []

    @contextlib.contextmanager
    def section(self, name: str):
        entry = [name, self.count() - self.base, 0]
        self.entries.append(entry)
        try:
            yield
        finally:
            entry[2] = self.count() - self.base - entry[1]


def section(name: str):
    """A model section: recorded into the plan of the capture in progress
    on this thread, else a :func:`span`."""
    recorder = getattr(_capture, "recorder", None)
    if recorder is not None:
        return recorder.section(name)
    return span(name)


@contextlib.contextmanager
def node_plan(path: str, count: Optional[Callable[[], int]]):
    """Record the sections of the capture this block runs as
    ``REGISTRY.plans[path]``.  ``count()`` gives the device nodes captured
    so far (:func:`capture_counter`); the block must end inside the
    capture.  With ``count`` None, or where the block raises, no plan is
    kept."""
    if count is None:
        yield
        return
    recorder = _PlanRecorder(count)
    outer = getattr(_capture, "recorder", None)
    _capture.recorder = recorder
    try:
        yield
        total = count() - recorder.base
    finally:
        _capture.recorder = outer
    REGISTRY.plans[path] = NodePlan(
        tuple(tuple(e) for e in recorder.entries), total)


# cudaGraphNodeType: kernel, memcpy, memset, the nodes that run on the card
_DEVICE_NODE_TYPES = (0, 1, 2)
_CAPTURE_ACTIVE = 1      # cudaStreamCaptureStatusActive


def _loaded_cudart():
    """The CUDA runtime library this process has loaded, or None."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libcudart.so"):
                return ctypes.CDLL(path)
    return None


def capture_counter(stream) -> Optional[Callable[[], int]]:
    """A function giving the device nodes captured so far into the graph
    ``stream`` (a ``torch.cuda.Stream``) is capturing, read by
    ``cudaStreamGetCaptureInfo`` and ``cudaGraphGetNodes`` of the runtime
    torch loaded; None where that runtime cannot be reached."""
    try:
        rt = _loaded_cudart()
    except OSError:
        return None
    if rt is None:
        return None
    get_info = getattr(rt, "cudaStreamGetCaptureInfo_v2", None) or \
        rt.cudaStreamGetCaptureInfo
    # (stream, status, id, graph, dependencies, count) in CUDA 12, an edge
    # array before the count in CUDA 13: the pointers past the graph are
    # all null, and a trailing argument the function does not take is
    # ignored, so one call serves both
    get_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_ulonglong),
                         ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p]
    get_nodes = rt.cudaGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_type = rt.cudaGraphNodeGetType
    get_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    for f in (get_info, get_nodes, get_type):
        f.restype = ctypes.c_int
    handle = ctypes.c_void_p(stream.cuda_stream)
    types: Dict[int, int] = {}

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed with CUDA error {err}")

    def count() -> int:
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        check(get_info(handle, ctypes.byref(status), None,
                       ctypes.byref(graph), None, None, None),
              "cudaStreamGetCaptureInfo")
        if status.value != _CAPTURE_ACTIVE:
            raise RuntimeError("the stream is not capturing")
        n = ctypes.c_size_t(0)
        check(get_nodes(graph, None, ctypes.byref(n)), "cudaGraphGetNodes")
        if n.value == 0:        # the runtime refuses an empty array
            return 0
        nodes = (ctypes.c_void_p * n.value)()
        check(get_nodes(graph, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
        for node in nodes[:n.value]:
            if node not in types:
                kind = ctypes.c_int()
                check(get_type(ctypes.c_void_p(node), ctypes.byref(kind)),
                      "cudaGraphNodeGetType")
                types[node] = kind.value
        return sum(types[node] in _DEVICE_NODE_TYPES
                   for node in nodes[:n.value])

    return count
