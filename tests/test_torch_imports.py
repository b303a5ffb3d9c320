"""The port, chip_smoke.py and the flash probes import neither JAX, flax
nor the JAX package, checked on the source AST of every module."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "multi_modal_transformers_tokenmerge_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "multi_modal_transformers_tokenmerge_tpu")


def _files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "flash_fwd_probe.py",
                                         ROOT / "flash_bwd_probe.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported(path)
           if m and m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    """Import every module of the port in a fresh interpreter: none of the
    forbidden packages ends up in sys.modules."""
    import subprocess
    import sys
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    for name in ("train.steps", "train.checkpoint", "train.loop",
                 "utils.recordio", "utils.episodes", "utils.spm",
                 "utils.logging", "utils.data", "modules.text",
                 "serve.policy", "serve.server", "utils.sim",
                 "utils.profiling", "utils.debug", "core.yaml_loader",
                 "core.global_batch",
                 "__main__", "parallel.distributed", "parallel.mesh",
                 "parallel.ring_attention", "parallel.pipeline",
                 "models.legacy", "modules.pointcloud",
                 "modules.offset_attention"):
        assert f"multi_modal_transformers_tokenmerge_torch.{name}" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
