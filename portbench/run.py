"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port
(``multi_modal_transformers_tokenmerge_torch``).  It measures on an NVIDIA
card only: without one it exits with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()    # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the port builds its kernels into its own _build/ inside the checkout; the
# caches of any library it loads go inside the checkout too, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
os.environ["USE_FLAX"] = "0"

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
