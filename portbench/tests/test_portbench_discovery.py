"""A configuration, a traffic mix, a cell, its limits and a per-layer
metric added as files and entries alone: a copy of the benchmark with
them added runs the new cell, no file of it edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.tests.tiny import bench

REPO = Path(__file__).resolve().parents[2]

READER = '''"""Units of traffic in the traced window."""


def read(ctx):
    return float(ctx.units)
'''

DRIVE = """
import json, sys, types
sys.path[:0] = [{tmp!r}, {repo!r}]
from portbench import harness
assert harness.__file__.startswith({tmp!r}), harness.__file__
rc = harness.main(["--workload", "tiny.t", "--seed", "3000000001",
                   "--seconds", "0.3", "--trace", "0"], device="cpu")
m = [x for x in json.load(open({manifest!r}))["per_layer"]
     if x["name"] == "ticks_seen.serve"][0]
_, layer = harness.cell_metrics(json.load(open({manifest!r})), "tiny.t")
assert m in layer
print("READER", harness.reader(m["name"]).read(types.SimpleNamespace(units=7)))
sys.exit(rc)
"""


def test_new_files_make_a_new_cell(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", copy,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench(copy)                                # configs/, traffic/, limits/
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    (copy / "BENCHMARK.json").unlink()
    manifest["per_layer"].append({
        "name": "ticks_seen.serve", "unit": "ticks", "better": "higher",
        "source": "device_trace", "layer": "Engine",
        "moves": "actions_per_s", "workloads": ["tiny.t"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (copy / "layer_metrics" / "ticks_seen.py").write_text(READER)
    assert all(p.read_bytes() == b for p, b in before.items())
    proc = subprocess.run(
        [sys.executable, "-c", DRIVE.format(
            tmp=str(tmp_path), repo=str(REPO),
            manifest=str(tmp_path / "BENCHMARK.json"))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-2])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"action_p95_ms", "actions_per_s",
                                      "peak_mem_gib",
                                      "setup_s"}
    assert lines[-1] == "READER 7.0"
