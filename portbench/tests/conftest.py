"""The benchmark's own tests: CPU-only but for those marked ``cuda``."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an sm_90 CUDA card; skips elsewhere")
