"""Readings that the limits of a cell's check are set from, on the card.

    python3 portbench/tools/calibrate.py --cell octo_deep.serve_b8 \\
        --seeds 12 --control-seeds 3

In one process, for each seed: the cell's set-up, a short window at the
cell's own load, and the numbers its check compares, for

- the program as the cell runs it (the lower readings);
- the control: the reference with every product's operands rounded to
  float8 e4m3, put in the program's place on the same sampled ticks (the
  upper readings), on the first ``--control-seeds`` seeds;
- the program with its own int8 image and text towers
  (``PolicyEngine(image_tower='int8', text_tower='int8')``), on the first
  ``--control-seeds`` seeds: the program's own lower-precision towers,
  read beside the control;
- the program with each fault of ``tools/faults.py`` planted in its
  transformer stack (a block dropped, the attention mask left out, every
  ToMe merge reversed where the configuration merges), on the same seeds.

Prints one JSON line a reading and writes them all to
``chiprun_out/calibrate_<cell>.json``.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.drivers.fleet_tick import Workload  # noqa: E402
from portbench.harness import load  # noqa: E402
from portbench.tools.faults import FAULTS, merges, planted  # noqa: E402


def reading(cell, config, traffic, seed, seconds, engine_kw=None,
            control=False, fault=None):
    t = time.perf_counter()
    with (planted(fault) if fault else contextlib.nullcontext()) as hook:
        work = Workload(config, traffic, seed, "cuda", engine_kw=engine_kw)
        work.setup()
        if hook is not None:
            hook(work)
        work.window(seconds)
    work.release()
    calls = work.sample()
    got = torch.cat([work.actions[i] for i in calls])
    want = work.reference_actions(calls)
    out = {"cell": cell, "seed": seed, "rows": int(got.shape[0]),
           "program": work.compared(got, want),
           "towers": "int8" if engine_kw else "bf16", "fault": fault}
    if control:
        fp8 = work.reference_actions(calls, operands=torch.float8_e4m3fn)
        out["control_fp8"] = work.compared(fp8, want)
    out["seconds"] = time.perf_counter() - t
    del work
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = {c["name"]: c for c in manifest["workloads"]}[args.cell]
    config = load("configs", cell["config"])
    # the readings judge outputs, not speed: a short warm-up does
    traffic = dict(load("traffic", cell["traffic"]), warmup_s=0.5)
    out = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        r = reading(args.cell, config, traffic, seed, args.seconds,
                    control=k < args.control_seeds)
        out.append(r)
        print(json.dumps(r), flush=True)
        if k >= args.control_seeds:
            continue
        others = [dict(engine_kw={"image_tower": "int8",
                                  "text_tower": "int8"})]
        others += [dict(fault=f) for f in FAULTS
                   if f != "merge_reversed" or merges(config["model"])]
        for kw in others:
            r = reading(args.cell, config, traffic, seed, args.seconds, **kw)
            out.append(r)
            print(json.dumps(r), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/calibrate_{args.cell}.json", "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "readings": out},
                  f, indent=1)


if __name__ == "__main__":
    main()
