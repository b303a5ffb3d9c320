"""A profiler session behind a guard, and the device timeline it records.

The guard is a frozen copy of ``chip_smoke.py``'s ``profiled`` /
``profile_session``: the card's profiler (torch 2.11, CUDA 12.8, one H100)
was seen to lose the device records of a session's first kernels, more
as the process ages, and now and then a whole session's, the launches
being all recorded.  So every session starts with ``GUARD_LAUNCHES``
launches of a kernel nothing else runs (``erfinv``), which take the loss
and count it; a session that kept none of them is run again, up to
``PROFILE_ATTEMPTS`` times.  The first session of a process learns the
guard kernel's name (:func:`learn_guard`).

:func:`timeline` reads a session's raw records: every device activity
(kernels, copies, sets) and every host event, in one clock.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List

import torch

__all__ = ["GUARD_LAUNCHES", "PROFILE_ATTEMPTS", "Guard", "Record",
           "timeline"]

GUARD_LAUNCHES = 256
PROFILE_ATTEMPTS = 5


class ProfileLost(Exception):
    """A session kept none of its guard records."""


@dataclass
class Record:
    name: str
    start_ns: int
    end_ns: int
    device: bool


@dataclass
class Guard:
    """The guard of one process: its kernel's name and each session's
    losses."""

    key: str = ""
    lost: List[int] = field(default_factory=list)
    retries: int = 0
    x: torch.Tensor = None

    def _launch(self):
        for _ in range(GUARD_LAUNCHES):
            self.x.erfinv_()

    @contextlib.contextmanager
    def session(self):
        from torch.profiler import ProfilerActivity, profile
        if self.x is None:
            self.x = torch.zeros(8, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self._launch()
            torch.cuda.synchronize()
            yield prof
            torch.cuda.synchronize()
        names = {r.name for r in timeline(prof) if r.device}
        if not self.key:
            if len(names) != 1:
                raise RuntimeError(f"the guard session saw the kernels "
                                   f"{sorted(names)}")
            self.key = names.pop()
        kept = sum(1 for r in timeline(prof) if r.device and r.name == self.key)
        self.lost.append(GUARD_LAUNCHES - kept)
        if kept == 0:
            raise ProfileLost

    def learn(self):
        """An empty session: the guard kernel's name."""
        self.run(lambda: None)

    def run(self, body):
        """``body()`` in a guarded session: (records, what body returned).
        A session that lost every guard record runs again, body too."""
        for _ in range(PROFILE_ATTEMPTS):
            try:
                with self.session() as prof:
                    out = body()
                return [r for r in timeline(prof) if r.name != self.key], out
            except ProfileLost:
                self.retries += 1
        raise RuntimeError(f"the profiler lost every guard record in "
                           f"{PROFILE_ATTEMPTS} sessions")


def timeline(prof) -> List[Record]:
    """Every record of a finished session, host and device, but the device
    side of host annotations."""
    events = prof.profiler.kineto_results.events()
    # a host annotation (record_function) also shows as a range on the
    # device's timeline; it is no device activity
    marks = {e.name() for e in events if e.is_user_annotation()}
    out = []
    for e in events:
        device = e.device_type() == torch.autograd.DeviceType.CUDA
        if device and (e.is_user_annotation() or e.name() in marks):
            continue
        out.append(Record(e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns(), device))
    return out
