"""Metric logging: JSON lines, with optional wandb.

Counterpart of the JAX package's ``utils/logging.py``, the logger ``fit``
logs to at its own cadence (metrics accumulate on the device in the train
state between logs).  wandb is optional: without it the logger writes JSON
lines to a file or a stream.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

__all__ = ["MetricLogger", "make_logger"]

try:  # pragma: no cover - wandb is optional
    import wandb as _wandb
except ImportError:
    _wandb = None


class MetricLogger:
    """Console/JSONL logger with optional wandb mirroring."""

    def __init__(self, project: Optional[str] = None, use_wandb: bool = False,
                 jsonl_path: Optional[str] = None, stream=None):
        self._stream = stream if stream is not None else sys.stderr
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._wandb_run = None
        if use_wandb:
            if _wandb is None:
                self._stream.write(
                    "[logging] wandb requested but not installed; "
                    "falling back to console\n")
            else:
                self._wandb_run = _wandb.init(project=project)

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        payload = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            payload["step"] = int(step)
        payload["time"] = time.time()
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()
        else:
            self._stream.write(json.dumps(payload) + "\n")
        if self._wandb_run is not None:
            self._wandb_run.log(payload, step=step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb_run is not None:
            self._wandb_run.finish()


def make_logger(**kw) -> MetricLogger:
    return MetricLogger(**kw)
