"""Card-only probe of the wide DDPM sampler kernel (csrc/ddpm_sampler_wide.cu).

    python3 sampler_wide_probe.py

Builds the shipped source and patched copies of it, each leaving one part
of a step out or changing one choice, and times each in turns with the
shipped kernel (shipped first and last), with CUDA events around direct
launches, at octo_base_chunk28's sampler (bf16 DDPM, T=100, H=3072, A=28;
B=1 and 64) and at octo_base's (T=32, H=768, A=8, B=1).  The patched
copies compute wrong results; they are timed, not held.  Copies:

- no_cluster_barrier: the step's cluster barrier replaced by __syncthreads;
- no_exchange: each block writes and adds its own partial sums only;
- no_ring: no stage issued after the first three (the loop reads stale
  stages);
- no_products: both products left out (the loop's skeleton);
- one_block: clusters of one block (the weights through L2 where they do
  not fit one block's shared memory).

Writes chiprun_out/sampler_wide_probe.json; run it after chip_smoke.py in
one call to reuse the built library, or alone.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs

PATCHES = {
    "no_cluster_barrier": [("      if (C > 1)\n        cluster_barrier();\n"
                            "      else\n        __syncthreads();\n",
                            "      __syncthreads();\n")],
    "no_exchange": [("          for (int k = 0; k < C; ++k) {\n",
                     "          for (int k = c; k <= c; ++k) {\n"),
                    ("        for (int k = 0; k < C; ++k)\n          e +=",
                     "        for (int k = c; k <= c; ++k)\n          e +=")],
    "no_ring": [("      issue(t + kStages - 1);\n", "")],
    "no_products": [("        if (n < units) {\n", "        if (false) {\n"),
                    ("        if (a < A) {\n", "        if (false) {\n")],
    "one_block": [("  if (c > kMaxCluster) c = kMaxCluster;\n",
                   "  c = 1;\n")],
}
# (label, T, B, H, A)
SHAPES = [("chunk28 T=100 B=1", 100, 1, 3072, 28),
          ("chunk28 T=100 B=64", 100, 64, 3072, 28),
          ("octo_base T=32 B=1", 32, 1, 768, 8)]


def patched(src, patches):
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"patch text found {src.count(old)} times: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(_build, sources):
    root = _build.BUILD_DIR / "probe"
    root.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, text in sources.items():
        cu = root / f"sampler_wide_{name}.cu"
        cu.write_text(text)
        so = root / f"libsampler_wide_{name}.so"
        running[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def caller(lib, x, coeffs, sms):
    from multi_modal_transformers_tokenmerge_torch.ops import (
        ddpm_sampler as tds)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ddpm_sampler_wide_launch.argtypes = [vp] * 10 + [ci] * 4 + [
        ctypes.c_float, ci, ci, ci, vp]
    lib.ddpm_sampler_wide_plan.argtypes = [ci] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)]
    t, b, h = x["contexts"].shape
    a = x["noisy"].shape[1]
    plan = tds.wide_plan(lib, t, b, h, a, 2, 0, sms)
    scratch = torch.empty(max(1, plan["scratch_floats"]), device="cuda")
    out = torch.empty_like(x["noisy"])

    def call():
        rc = lib.ddpm_sampler_wide_launch(
            x["noisy"].data_ptr(), x["contexts"].data_ptr(),
            x["noise"].data_ptr(), coeffs.data_ptr(), x["wn"].data_ptr(),
            x["bn"].data_ptr(), x["wo"].data_ptr(), x["bo"].data_ptr(),
            out.data_ptr(), scratch.data_ptr(), t, b, h, a, 5.0, 1, 0, sms,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed: {rc}")
    return call, plan


def main():
    if not torch.cuda.is_available():
        cs.log("no CUDA device: sampler_wide_probe.py runs on the card only")
        return 2
    from multi_modal_transformers_tokenmerge_torch import _build
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        DiffusionHeadConfig)
    from multi_modal_transformers_tokenmerge_torch.heads.diffusion import (
        DiffusionActionHead)
    card = cs.card_line()
    cs.log(card)
    src = _build.sources()["ddpm_sampler_wide"].read_text()
    libs = build(_build, {"shipped": src, **{
        k: patched(src, p) for k, p in PATCHES.items()}})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    readings = {}
    for label, t, b, h, a in SHAPES:
        head = DiffusionActionHead(DiffusionHeadConfig(
            diffusion_steps=t, action_space_dim=a, mlp_dim=h), h,
            device="cuda")
        coeffs = head.schedule(None)[1].float().contiguous()
        x = cs.sampler_inputs(head, b, t, torch.bfloat16, seed=b)
        x.update({k: x[k].to(torch.bfloat16).contiguous()
                  for k in ("wn", "bn", "wo", "bo")})
        calls = {n: caller(lib, x, coeffs, sms) for n, lib in libs.items()}
        order = list(calls)
        times = {}
        for name in order + order[::-1]:
            times.setdefault(name, []).append(cs.time_ms(calls[name][0]))
        row = {n: sum(v) / len(v) * 1e3 for n, v in times.items()}
        readings[label] = {"us": row, "plans": {
            n: calls[n][1] for n in ("shipped", "one_block")}}
        cs.log(f"  {label} us: {row}")
    result = {"card": card, "readings": readings}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "sampler_wide_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
