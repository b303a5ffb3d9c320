"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which :func:`load_library` opens with
``ctypes``.  The build happens at first use, into ``_build/`` beside this
file, keyed by a hash of the sources and flags, so a changed source builds
anew and an unchanged one is reused.  :func:`build_all` starts one ``nvcc``
per missing source, all at once, and returns each library's compiler
report (``-Xptxas -v``: registers, shared memory and spills of every
kernel), kept beside the library, so a reused library reports what it was
built with.  A failed build raises; nothing falls back.

``nvcc`` is looked for under ``$CUDA_HOME``, then on ``PATH``, then under
``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "KernelBuildError", "build_all",
           "load_library", "sources"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def sources() -> Dict[str, Path]:
    """Kernel name -> source file, one per ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):  # headers count too
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _report_path(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def build_all(names=None) -> Dict[str, str]:
    """Build every kernel of ``names`` (default: all sources) whose library
    is missing, one ``nvcc`` process each, all started together.  Returns
    kernel name -> the compiler's output, read back from beside the library
    for one already built."""
    names = sorted(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running, reports = {}, {}
    for name in names:
        if name not in sources():
            raise KernelBuildError(f"no kernel source csrc/{name}.cu")
        target = _target(name)
        if target.exists():
            report = _report_path(target)
            reports[name] = report.read_text() if report.exists() else ""
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(sources()[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target)
    failed = []
    for name, (proc, tmp, target) in running.items():
        reports[name], _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{reports[name]}")
        else:
            # the report first, then the library; each replace is atomic, so
            # concurrent builds agree
            fd, tmp_report = tempfile.mkstemp(suffix=".txt", dir=BUILD_DIR)
            with os.fdopen(fd, "w") as f:
                f.write(reports[name])
            os.replace(tmp_report, _report_path(target))
            os.replace(tmp, target)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if name not in sources():
        raise KernelBuildError(f"no kernel source csrc/{name}.cu")
    target = _target(name)
    if not target.exists():
        build_all([name])
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as e:
        raise KernelBuildError(f"cannot load kernel library {name}: {e}")
    _loaded[name] = lib
    return lib
