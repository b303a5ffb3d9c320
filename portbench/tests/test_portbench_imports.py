"""What the benchmark imports: nothing of JAX or the JAX package anywhere;
nothing of the program in the reference and the counters."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "multi_modal_transformers_tokenmerge_tpu"}
PROGRAM = "multi_modal_transformers_tokenmerge_torch"
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_side(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for path in (BENCH / sub).rglob("*.py"):
        assert PROGRAM not in top_level_imports(path), path
    for path in (BENCH / "weights.py", BENCH / "profiling.py"):
        assert PROGRAM not in top_level_imports(path), path
