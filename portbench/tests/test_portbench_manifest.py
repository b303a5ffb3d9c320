"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell names."""

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench.harness import cell_metrics
from portbench.tests.tiny import model_of

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [c["name"] for c in MANIFEST["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_entries():
    assert set(MANIFEST) == KEYS
    for kind, keys in ENTRY_KEYS.items():
        for entry in MANIFEST[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
                else set()
            assert keys <= set(entry) <= keys | extra, entry


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_names_units_and_lines(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert NAME.fullmatch(e["name"]), e["name"]
        for key in ("why", "layer"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)
        if kind == "configs":
            assert one_line(e["source"])
            assert all(NAME.fullmatch(k) for k in e["reduced"])
        if kind == "workloads":
            assert NAME.fullmatch(e["config"])
            assert NAME.fullmatch(e["traffic"])
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25


def test_paths_command_and_time_budget():
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    secs = MANIFEST["run_seconds"]
    assert isinstance(secs, int) and 1 <= secs <= 51
    cells = 24
    total = (2 + 14 * cells) * (secs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_cells_four_chips_and_pairs():
    cells = MANIFEST["workloads"]
    four = sum(c["chips"] == 4 for c in cells)
    assert all(c["chips"] in (1, 4) for c in cells)
    assert four <= max(1, len(cells) // 4)
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert {c["config"] for c in cells} == configs


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e, layer = cell_metrics(MANIFEST, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])


def test_every_layer_metric_moves_a_metric_its_cells_report():
    for m in MANIFEST["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            e2e, _ = cell_metrics(MANIFEST, cell)
            assert m["moves"] in {x["name"] for x in e2e}, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_names(cell):
    c = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    bench = REPO / "portbench"
    traffic = json.loads((bench / "traffic" / f"{c['traffic']}.json")
                         .read_text())
    importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    limits = json.loads((bench / "limits" / f"{cell}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    _, layer = cell_metrics(MANIFEST, cell)
    for m in layer:
        reader = importlib.import_module(
            f"portbench.layer_metrics.{m['name'].split('.')[0]}")
        assert callable(reader.read)


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=[c["name"] for c in MANIFEST["configs"]])
def test_configuration_files(entry):
    path = REPO / entry["file"]
    assert entry["file"].startswith("portbench/configs/")
    cfg = json.loads(path.read_text())
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    assert (REPO / "portbench" / "reference" / f"{cfg['reference']}.py"
            ).is_file()
    # the file states the model the program builds from its preset
    assert model_of(cfg["preset"], cfg["overrides"]) == cfg["model"]


def test_manifest_is_small():
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
