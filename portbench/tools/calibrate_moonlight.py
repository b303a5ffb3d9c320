"""Readings that the limit of ``octo_moonlight.serve_b8``'s check is set
from, on the card (``tools/calibrate.py`` for the bfloat16 driver).

    python3 portbench/tools/calibrate_moonlight.py --seeds 12 \\
        --control-seeds 3

In one process, for each seed: the cell's set-up with a short warm-up, a
short window, and the number its check compares (the actions' error
against the float32 reference over the witness's: the reference with every
product's operands in bfloat16, the configuration's precision; each error
on its own beside it), for

- the program as the cell runs it (the lower readings);
- the control: the reference with every product's operands rounded to
  float8 e4m3, put in the program's place (the upper readings), on the
  first ``--control-seeds`` seeds;
- the program with each fault of ``FAULTS`` planted, on those seeds: a
  block dropped (``first_block_dropped``: the dense block's attention and
  MLP outputs zeroed; ``last_block_dropped``: the last routed block's
  attention, expert and shared outputs zeroed), ``mask_off``
  (``tools/faults.py``'s), ``shared_dropped`` (the shared experts' output
  zeroed in every routed layer), ``rope_off`` (no rotation),
  ``scale_one`` (routing weights not scaled by 2.446) and
  ``bias_ignored`` (experts chosen by score alone).

Prints one JSON line a reading and writes them all to
``chiprun_out/calibrate_octo_moonlight.serve_b8.json``.
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

from portbench.drivers.fleet_tick_bf16 import Workload  # noqa: E402
from portbench.harness import load  # noqa: E402
from portbench.tools import faults  # noqa: E402

CELL = "octo_moonlight.serve_b8"
FAULTS = ("first_block_dropped", "last_block_dropped", "mask_off",
          "shared_dropped", "rope_off", "scale_one", "bias_ignored")
# the outputs of a block's branches: its attention's, its MLP's or its
# experts' and shared experts'
BRANCH_OUTPUTS = ("attention.out.weight", "mlp.down.weight", "moe.w_down",
                  "moe.shared.down.weight")


def _zero(work, pattern):
    with torch.no_grad():
        for name, p in work.engine._model.named_parameters():
            if pattern(name):
                p.zero_()


def _block(prefix):
    return lambda name: (name.startswith(prefix)
                         and name.endswith(BRANCH_OUTPUTS))


@contextlib.contextmanager
def planted(name):
    """The fault ``name`` switched on: yields the hook handed the driver
    after set-up, or None."""
    from multi_modal_transformers_tokenmerge_torch.modules import latent_moe
    saved = []

    def switch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    hook = None
    if name == "first_block_dropped":
        hook = lambda work: _zero(work, _block("transformer.stage_0.0."))
    elif name == "last_block_dropped":
        hook = lambda work: _zero(work, _block("transformer.stage_2.8."))
    elif name == "shared_dropped":
        hook = lambda work: _zero(
            work, lambda n: n.endswith("moe.shared.down.weight"))
    elif name == "rope_off":
        switch(latent_moe, "apply_rope", lambda x, cos, sin: x)
    elif name in ("scale_one", "bias_ignored"):
        route = latent_moe.route

        def changed(scores, bias, k, scale):
            if name == "scale_one":
                scale = 1.0
            else:
                bias = torch.zeros_like(bias)
            return route(scores, bias, k, scale)

        switch(latent_moe, "route", changed)
    try:
        if name == "mask_off":
            with faults.planted("mask_off") as hook:
                yield hook
        else:
            yield hook
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def rms_rel(got, want):
    return ((got - want).norm() / want.norm()).item()


def reading(config, traffic, seed, seconds, control=False, fault=None):
    t = time.perf_counter()
    with (planted(fault) if fault else contextlib.nullcontext()) as hook:
        work = Workload(config, traffic, seed, "cuda")
        work.setup()
        if hook is not None:
            hook(work)
        work.window(seconds)
    work.release()
    calls = work.sample()
    got = torch.cat([work.actions[i] for i in calls])
    want = work.reference_actions(calls)
    witness = work.reference_actions(calls, operands=torch.bfloat16)
    out = {"cell": CELL, "seed": seed, "rows": int(got.shape[0]),
           "program": work.compared_to_witness(got, want, witness),
           "fault": fault, "program_rms_rel": rms_rel(got, want),
           "witness_rms_rel": rms_rel(witness, want)}
    if control:
        fp8 = work.reference_actions(calls, operands=torch.float8_e4m3fn)
        out["control_fp8"] = work.compared_to_witness(fp8, want, witness)
        out["control_fp8_rms_rel"] = rms_rel(fp8, want)
    out["seconds"] = time.perf_counter() - t
    del work
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--faults", default=",".join(FAULTS),
                    help="the faults read on the control seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = {c["name"]: c for c in manifest["workloads"]}[CELL]
    config = load("configs", cell["config"])
    # the readings judge outputs, not speed: a short warm-up does
    traffic = dict(load("traffic", cell["traffic"]), warmup_s=0.5)
    out = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        runs = [dict(control=k < args.control_seeds)]
        if k < args.control_seeds:
            runs += [dict(fault=f) for f in args.faults.split(",") if f]
        for kw in runs:
            r = reading(config, traffic, seed, args.seconds, **kw)
            out.append(r)
            print(json.dumps(r), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/calibrate_{CELL}.json", "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "readings": out},
                  f, indent=1)


if __name__ == "__main__":
    main()
