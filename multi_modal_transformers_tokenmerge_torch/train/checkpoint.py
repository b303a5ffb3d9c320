"""Checkpointing of the train state.

Counterpart of the JAX package's ``train/checkpoint.py``, which wraps an
orbax ``CheckpointManager`` with asynchronous saves.  Here a checkpoint is
one ``torch.save`` of the state's state dict (parameters, optimizer
moments and count, EMA, metrics, step, every generator's state) per step,
written to a temporary file and renamed into place, so that a reader never
sees a torn file.  Retention, the data-state sidecar and the method names
follow the JAX class.

Saves are asynchronous, as orbax's with ``enable_async_checkpointing``:
:meth:`CheckpointManager.save` takes a snapshot of the state and returns;
a writer thread writes it.  The snapshot is a copy on the state's device,
enqueued on the current stream, so the next step, which updates the
state in place on that stream, cannot change it; the writer copies it to
the host on a stream of its own once an event recorded after the copy has
passed, and the snapshot's device memory (one state's size) is freed when
that copy ends.  Retention prunes after the save lands.  :meth:`wait`
joins the writer; a second save waits for the first, as orbax does; an
error of the writer is raised by the next ``wait``, ``save`` or ``close``.
:meth:`all_steps`, :meth:`latest_step` and :meth:`restore` see only
saves that have landed (``restore`` waits for the one in flight).  The
data-state and metrics sidecars are written before ``save`` returns, as
the JAX package writes them.

Under ``torch.distributed``: a state whose parameters are sharded
(DTensors, ``parallel.mesh.shard_params``) is saved through
``torch.distributed.checkpoint.async_save`` (staged to host memory before
it returns) into a directory ``{step}.dcp``, each rank writing and
reading back its own shards; the directory counts as a checkpoint once
its ``.metadata`` is written.  A replicated (data-parallel) state keeps
the one-file format, written by rank 0.  Every rank calls save, wait and
restore.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^(\d+)\.(pt|dcp)$")


def _sharded(state) -> bool:
    return any(hasattr(p, "placements")
               for p in getattr(state, "params", {}).values())


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _snapshot(obj):
    """A copy of every tensor of a state dict, on its device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    return obj


def _to_host(obj, streams):
    """The snapshot on the host, each device's tensors copied on its
    stream of ``streams`` (the copies waited for)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cuda":
            return obj
        with torch.cuda.stream(streams[obj.device]):
            return obj.to("cpu")
    if isinstance(obj, dict):
        return {k: _to_host(v, streams) for k, v in obj.items()}
    return obj


def _devices(obj, out=None):
    out = set() if out is None else out
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _devices(v, out)
    return out


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    """Save and restore :class:`~.state.OctoTrainState` under a directory.

    Keeps the newest ``max_to_keep`` checkpoints, or with ``best_metric``
    the ``max_to_keep`` best by that metric of the ``metrics`` each save
    carries (``best_mode`` 'min' or 'max'; ``fit`` passes its latest eval
    result).  As in the orbax manager of the JAX package: metrics that lack
    ``best_metric`` count as the worst; a save made with no metrics at all
    (before ``fit``'s first eval) is kept and counts towards no limit;
    ties keep the newer step; ``save_interval_steps`` skips saves at steps
    that are not a multiple of it."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 best_metric: Optional[str] = None,
                 best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got "
                             f"{best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.best_metric = best_metric
        self.best_mode = best_mode
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._cpu_group = None

    # -- steps on disk ------------------------------------------------------

    def _path(self, step: int) -> str:
        dcp = os.path.join(self.directory, f"{step}.dcp")
        return dcp if os.path.isdir(dcp) else os.path.join(
            self.directory, f"{step}.pt")

    def _metrics_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.metrics.json")

    @property
    def _data_dir(self) -> str:
        return os.path.join(self.directory, "data_state")

    def all_steps(self):
        """Every step with a checkpoint that has landed, in increasing
        order."""
        steps = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m and (m.group(2) == "pt" or os.path.exists(
                    os.path.join(self.directory, name, ".metadata"))):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore -------------------------------------------------------

    def save(self, step: int, state, data_state: Optional[dict] = None,
             metrics: Optional[dict] = None) -> bool:
        """Start writing ``state`` as checkpoint ``step`` and return once
        its snapshot is taken; returns whether a save was started (not at
        a step off ``save_interval_steps``, nor at a step already saved).
        A save still in flight is waited for first.  ``data_state`` (a
        small JSON-serialisable dict, e.g. ``RecordReader.state()``) is
        written beside it for :meth:`restore_data_state`."""
        step = int(step)
        self.wait()  # one save in flight at most; every rank sees its steps
        if step % self.save_interval_steps or step in self.all_steps():
            return False
        if _rank() == 0:
            # the sidecars first: the retention that follows the save reads
            # its metrics
            _atomic_write(self._metrics_path(step),
                          lambda f: f.write(json.dumps(metrics).encode()))
            if data_state is not None:
                os.makedirs(self._data_dir, exist_ok=True)
                _atomic_write(os.path.join(self._data_dir, f"{step}.json"),
                              lambda f: f.write(
                                  json.dumps(data_state).encode()))
        if _sharded(state):
            import torch.distributed.checkpoint as dcp
            future = dcp.async_save(
                state.state_dict(), checkpoint_id=os.path.join(
                    self.directory, f"{step}.dcp"),
                process_group=self._group_with_cpu())
            self._start(future.result)
        elif _rank() == 0:
            self._start(self._writer_of(step, state.state_dict()))
        _barrier()
        return True

    def _writer_of(self, step: int, state_dict) -> Callable[[], None]:
        """The writer thread's work for a one-file save: the snapshot is
        taken here, on the caller's stream; the thread copies it to the
        host behind an event and writes it."""
        held = [_snapshot(state_dict)]
        events = {}
        for d in _devices(held[0]):
            events[d] = torch.cuda.Event()
            events[d].record(torch.cuda.current_stream(d))
        path = os.path.join(self.directory, f"{step}.pt")

        def write():
            streams = {}
            for d, event in events.items():
                streams[d] = torch.cuda.Stream(d)
                streams[d].wait_event(event)
            # the device copy is freed once it is on the host
            host = _to_host(held.pop(), streams)
            _atomic_write(path, lambda f: torch.save(host, f))
        return write

    def _start(self, write: Callable[[], None]) -> None:
        """Run ``write`` and then the retention on the writer thread."""
        def run():
            try:
                write()
                if _rank() == 0:
                    self._prune()
            except BaseException as e:   # raised by the next wait()
                self._error = e
        self._writer = threading.Thread(target=run, name="checkpoint-writer",
                                        daemon=True)
        self._writer.start()

    def _group_with_cpu(self):
        """A process group ``async_save`` can use: the default one when it
        has a CPU backend, else a gloo group over the same ranks, made once
        (every rank calls save)."""
        if not dist.is_initialized():
            return None
        from torch.distributed.distributed_c10d import _get_default_group
        pg = _get_default_group()
        if torch.device("cpu") in pg._device_types:
            return None
        if self._cpu_group is None:
            self._cpu_group = dist.new_group(backend="gloo")
        return self._cpu_group

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place and return it, after the save in flight has landed.  A step
        compiled before (``train.steps``) is captured anew at its next call
        on the restored state."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step)
        if path.endswith(".dcp"):
            # into the state's own tensors: each rank reads its shards
            import torch.distributed.checkpoint as dcp
            saved = state.state_dict()
            dcp.load(saved, checkpoint_id=path)
        else:
            # on the host first: the generators' states are CPU byte
            # tensors; load_state_dict copies the rest onto the state's
            # device
            saved = torch.load(path, map_location="cpu", weights_only=True)
        state.load_state_dict(saved)
        return state

    def restore_data_state(self, step: Optional[int] = None
                           ) -> Optional[dict]:
        """The data-stream position saved with ``step`` (default: the
        latest), or None when that save carried none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._data_dir, f"{step}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def wait(self):
        """Block until the save in flight (if any) has landed and been
        pruned; raise the writer's error if it failed.  Every rank calls
        it."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        _barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"checkpoint save in {self.directory} "
                               f"failed") from error

    def close(self):
        """Wait for the save in flight."""
        self.wait()

    # -- retention --------------------------------------------------------------

    def _metrics(self, step: int) -> Optional[dict]:
        try:
            with open(self._metrics_path(step)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _prune(self):
        steps = self.all_steps()
        if self.best_metric is None:
            keep = set(steps[-self.max_to_keep:])
        else:
            worst = float("inf") if self.best_mode == "min" else float("-inf")
            sign = 1.0 if self.best_mode == "min" else -1.0
            scored, keep = [], set()
            for s in steps:
                metrics = self._metrics(s)
                if metrics is None:
                    keep.add(s)
                else:
                    scored.append((sign * float(metrics.get(self.best_metric,
                                                            worst)), -s))
            keep.update(-s for _, s in sorted(scored)[:self.max_to_keep])
        for s in steps:
            if s not in keep:
                for path in (self._path(s), self._metrics_path(s),
                             os.path.join(self._data_dir, f"{s}.json")):
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    elif os.path.exists(path):
                        os.remove(path)
