"""On the card: every cell's control at the cell's own size, on three
seeds, fails its limit while the program passes it, and so do a block
dropped from the program's stack and its attention mask left out (the
readings ``tools/calibrate.py`` takes for ``PERF.md``).  Run on the card with
``python -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py``
from the repository's root."""

import json
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in MANIFEST["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench.harness import load
    from portbench.tools.calibrate import reading
    c = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    limits = load("limits", cell)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r = reading(cell, load("configs", c["config"]),
                    load("traffic", c["traffic"]), seed, 1.0, control=True)
        for name, limit in limits.items():
            assert r["program"][name] <= limit, r
            assert r["control_fp8"][name] > limit, r
        for fault in ("block_dropped", "mask_off"):
            r = reading(cell, load("configs", c["config"]),
                        load("traffic", c["traffic"]), seed, 1.0,
                        fault=fault)
            for name, limit in limits.items():
                assert r["program"][name] > limit, r
