"""One run of one cell: set-up, a measured window, the check against the
plain reference, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in ``configs/<config>.json``; its
traffic in ``traffic/<traffic>.json``, whose ``driver`` names the module
of ``drivers/`` that runs it; its limits in ``limits/<cell>.json``; each
per-layer metric's reader in ``layer_metrics/`` (by the part of its name
before the first dot).  A new configuration, traffic mix, cell, limit or
per-layer metric is a new file and a new entry; no file here changes.

With ``--trace 0`` the window lasts ``--seconds`` and the result carries
the cell's end-to-end metrics; with ``--trace 1`` the window is one
profiled session of at most ``TRACE_SECONDS`` and the result carries the
cell's per-layer metrics and the breakdown.  Both runs check their output.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import math
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .profiling import Guard, Record

__all__ = ["main", "TraceContext", "cell_metrics", "load"]

BENCH_DIR = Path(__file__).resolve().parent
# what must not be loaded in the process that prints the result, compared
# by the top-level name of each module
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_modal_transformers_tokenmerge_tpu")
TRACE_SECONDS = 1.0
BREAKDOWN_ENTRIES = 10
NO_CARD = 2
REFUSED = 3


def load(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    """The JSON file ``<kind>/<name>.json`` of the benchmark."""
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"missing {path}")
    return json.loads(path.read_text())


def cell_metrics(manifest: Dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def reader(name: str):
    return importlib.import_module(
        f"{__package__}.layer_metrics.{name.split('.')[0]}")


@dataclass
class TraceContext:
    """What a per-layer reader sees of a traced window."""

    records: List[Record]       # device and host records inside the window
    start_ns: int
    end_ns: int
    units: int
    counts: Dict                # the driver's per-unit counts

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def device(self) -> List[Record]:
        return [r for r in self.records if r.device]

    def kernels(self, pattern: Optional[str] = None) -> List[Record]:
        """Device kernel records (no copies or sets), those whose name
        holds ``<pattern>_kernel`` as a word where a pattern is given."""
        out = [r for r in self.device()
               if not r.name.startswith(("Memcpy", "Memset"))]
        if pattern is not None:
            rx = re.compile(rf"\b{pattern}_kernel\b")
            out = [r for r in out if rx.search(r.name)]
        return out

    def busy_intervals(self):
        """The union of device activity, clipped to the window, merged."""
        spans = sorted((max(r.start_ns, self.start_ns),
                        min(r.end_ns, self.end_ns)) for r in self.device())
        merged = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def breakdown(self) -> Dict:
        """The device operations that took most time, and the idle gaps by
        what the host was doing (the shortest host record that spans the
        gap's middle)."""
        ops: Dict[str, float] = {}
        for r in self.device():
            key = r.name[:96]
            ops[key] = ops.get(key, 0.0) + (r.end_ns - r.start_ns) * 1e-9
        host = sorted((r for r in self.records if not r.device),
                      key=lambda r: r.start_ns)
        starts = [r.start_ns for r in host]
        gaps: Dict[str, float] = {}
        edge = self.start_ns
        for s, e in self.busy_intervals() + [[self.end_ns, self.end_ns]]:
            if s > edge:
                mid = (edge + s) // 2
                spans = [r for r in host[:bisect.bisect_right(starts, mid)]
                         if r.end_ns >= mid and r.name != WINDOW_MARK]
                what = (min(spans, key=lambda r: r.end_ns - r.start_ns).name
                        if spans else "no host record")
                gaps[what] = gaps.get(what, 0.0) + (s - edge) * 1e-9
            edge = max(edge, e)
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


WINDOW_MARK = "portbench.window"


def traced_window(work, seconds: float):
    """The driver's window as one guarded profiler session: (stats, the
    trace context)."""
    guard = Guard()
    guard.learn()

    def body():
        with torch.profiler.record_function(WINDOW_MARK):
            return work.window(seconds, annotate=True)

    records, stats = guard.run(body)
    mark = [r for r in records if r.name == WINDOW_MARK and not r.device]
    if len(mark) != 1:
        raise SystemExit(f"the trace holds {len(mark)} window marks")
    start, end = mark[0].start_ns, mark[0].end_ns
    inside = [r for r in records if r.end_ns > start and r.start_ns < end]
    ctx = TraceContext(inside, start, end, stats["units"],
                       work.layer_counts())
    return stats, ctx, guard


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None, device: str = "cuda",
         bench_dir: Path = BENCH_DIR, manifest_path: Optional[Path] = None,
         planted=None) -> int:
    """Run one cell and print its result line; returns the exit code.
    ``device``, ``bench_dir``, ``manifest_path`` and ``planted`` (a
    callable handed the driver after set-up, which may break it) are for
    the benchmark's own tests; a run from the command line takes the
    defaults, and ``device='cuda'`` requires the cell's cards."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    manifest_path = manifest_path or bench_dir.parent / "BENCHMARK.json"
    manifest = json.loads(Path(manifest_path).read_text())
    cells = {c["name"]: c for c in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in {manifest_path}", file=sys.stderr)
        return REFUSED
    cell = cells[args.workload]
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card: the benchmark measures only on one",
                  file=sys.stderr)
            return NO_CARD
        if torch.cuda.device_count() < cell["chips"]:
            print(f"the cell asks for {cell['chips']} cards; "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return NO_CARD
        torch.cuda.reset_peak_memory_stats()
        # load from one process with few threads: the window's host work is
        # the program's own dispatch
        torch.set_num_threads(1)
    config = load("configs", cell["config"], bench_dir)
    traffic = load("traffic", cell["traffic"], bench_dir)
    limits = load("limits", cell["name"], bench_dir)
    driver = importlib.import_module(
        f"{__package__}.drivers.{traffic['driver']}")
    e2e, layer = cell_metrics(manifest, cell["name"])
    work = driver.Workload(config, traffic, args.seed, device)
    work.setup()
    if planted is not None:
        planted(work)
    setup_s = time.perf_counter() - t0
    if args.trace:
        stats, ctx, guard = traced_window(
            work, min(args.seconds, TRACE_SECONDS))
    else:
        stats = work.window(args.seconds)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return REFUSED
    metrics = {}
    if args.trace:
        for m in layer:
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(work.end_to_end(stats), setup_s=setup_s,
                      peak_mem_gib=peak / 2**30)
        for m in e2e:
            if m["name"] not in values:
                print(f"the {traffic['driver']} driver gives no "
                      f"{m['name']}", file=sys.stderr)
                return REFUSED
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    work.release()
    numbers = work.check()
    checked = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checked.values()) and set(numbers) == set(limits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": stats["units"], "failed": 0,
              "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = ctx.busy_s()
        dev["window_s"] = ctx.window_s
        result["breakdown"] = ctx.breakdown()
        result["profiler"] = {"guard_lost": guard.lost,
                              "sessions_run_again": guard.retries}
    result["checked"] = checked
    for k, v in checked.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
