"""Share of its roofline that the grouped expert products reach
(``expert_gate_up_kernel`` and ``expert_down_kernel`` of the port's
``ops/grouped_experts.py``): the least time of their launches
(``counts.moonlight.expert_bytes_flops`` at each routed layer's token
count, ``counts.kernels.bound``: bytes at 3.35 TB/s or FLOPs at 989
TFLOP/s, whichever is longer), over their device time, in percent.  Each
record stands for the mean launch of its kernel over a tick's calls.
Nothing where no such kernel ran."""

import re

from ..counts.kernels import bound
from ..counts.moonlight import expert_bytes_flops

KERNEL = re.compile(r"expert_(gate_up|down)_kernel")


def read(ctx):
    calls = ctx.counts.get("expert_calls") or []
    records = [(r, m.group(1)) for r in ctx.kernels()
               for m in [KERNEL.search(r.name)] if m]
    if not records or not calls:
        return None
    dtype = ctx.counts["dtype"]
    mean = {kind: sum(bound(*expert_bytes_flops(c, dtype)[kind], dtype)[0]
                      for c in calls) / len(calls)
            for kind in ("gate_up", "down")}
    least = sum(mean[kind] for _, kind in records)
    spent = sum(r.end_ns - r.start_ns for r, _ in records) * 1e-9
    return 100.0 * least / spent
