"""Checkpointing of the train state.

Counterpart of the JAX package's ``train/checkpoint.py``, which wraps an
orbax ``CheckpointManager``.  Here a checkpoint is one ``torch.save`` of
the state's state dict (parameters, optimizer moments and count, EMA,
metrics, step, every generator's state) per step, written to a temporary
file and renamed into place, so that a reader never sees a torn file.
Retention, the data-state sidecar and the method names follow the JAX
class.  Saves are synchronous, so :meth:`CheckpointManager.wait` has
nothing to wait for.

Under ``torch.distributed``: a state whose parameters are sharded
(DTensors, ``parallel.mesh.shard_params``) is saved and restored through
``torch.distributed.checkpoint`` into a directory ``{step}.dcp``, each rank
writing and reading back its own shards; a replicated (data-parallel)
state keeps the one-file format, written by rank 0.  Every rank calls
save and restore.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

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
        """Every step with a checkpoint, in increasing order."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore -------------------------------------------------------

    def save(self, step: int, state, data_state: Optional[dict] = None,
             metrics: Optional[dict] = None) -> bool:
        """Write ``state`` as checkpoint ``step``; returns whether a save was
        made (not at a step off ``save_interval_steps``, nor at a step
        already saved).  ``data_state`` (a small JSON-serialisable dict, e.g.
        ``RecordReader.state()``) is written beside it for
        :meth:`restore_data_state`."""
        step = int(step)
        _barrier()   # every rank sees the same steps on disk
        if step % self.save_interval_steps or step in self.all_steps():
            return False
        if _sharded(state):
            import torch.distributed.checkpoint as dcp
            dcp.save(state.state_dict(), checkpoint_id=os.path.join(
                self.directory, f"{step}.dcp"))
        elif _rank() == 0:
            _atomic_write(self._path(step),
                          lambda f: torch.save(state.state_dict(), f))
        if _rank() == 0:
            _atomic_write(self._metrics_path(step),
                          lambda f: f.write(json.dumps(metrics).encode()))
            if data_state is not None:
                os.makedirs(self._data_dir, exist_ok=True)
                _atomic_write(os.path.join(self._data_dir, f"{step}.json"),
                              lambda f: f.write(
                                  json.dumps(data_state).encode()))
            self._prune()
        _barrier()
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place and return it.  A step compiled before (``train.steps``) is
        captured anew at its next call on the restored state."""
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
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open between saves."""

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
