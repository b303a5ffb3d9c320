"""Probe of the bf16 tensor-core flash forward on one H100.

    python3 flash_fwd_probe.py

Builds patched copies of ``csrc/flash_attention.cu`` (one ``nvcc`` each, all
at once) and reads the device time of ``flash_fwd`` and, with dropout 0.1,
``flash_fwd_lse`` under each beside the shipped library, in turns (shipped,
variants, variants reversed, shipped) at the shapes ``chip_smoke.py`` times:

    rows32        32-row blocks at head dim 64 (two warps) in place of 64
    philox_twice  each lane draws the Philox counters of both its rows, no
                  shuffle
    expf          the accurate expf in place of ex2.approx
    no_qk         the S = Q K^T products left out (their operand loads stay)
    no_pv         the O += P V products left out

The first three compute the same function: each is held against the plain
version (bf16, in units of eps * (1 + |plain|)) and recorded.  The last two
are ablations, wrong by design and timed only.  Writes every reading to
``chiprun_out/flash_fwd_probe.json`` and prints it as the last line.  Needs
the card and ``nvcc``; the shipped kernels are held by ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs

# name -> [(text of csrc/flash_attention.cu, its replacement)], each text
# found exactly once
PATCHES = {
    "rows32": [(
        "constexpr int RG = Traits<D>::FWD_RG, DS = Traits<D>::FWD_DS;",
        "constexpr int RG = D == 64 ? 2 : Traits<D>::FWD_RG, "
        "DS = Traits<D>::FWD_DS;")],
    "philox_twice": [(
        """        const bool odd = t & 1;
        const uint4 w = philox4x32_10(
            make_uint4(ctr, row + (odd ? 8u : 0u), bh + drop.bh0, 0u),
            drop.k0, drop.k1);
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        // [row g, row g + 8][column 2t, 2t + 1]
        const uint32_t bits[2][2] = {{odd ? r0 : w.x, odd ? r1 : w.y},
                                     {odd ? w.z : r0, odd ? w.w : r1}};
""",
        """        uint32_t bits[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 w = philox4x32_10(
              make_uint4(ctr, row + 8u * i, bh + drop.bh0, 0u), drop.k0,
              drop.k1);
          bits[i][0] = (t & 1) ? w.z : w.x;
          bits[i][1] = (t & 1) ? w.w : w.y;
        }
""")],
    "expf": [
        ("alpha[i] = ex2_approx((m[i] - mx[i]) * kLog2e);",
         "alpha[i] = expf(m[i] - mx[i]);"),
        ("s[j][e] = ex2_approx(fmaf(s[j][e], kLog2e, -ref[e >> 1]));",
         "s[j][e] = expf(s[j][e] - ref[e >> 1] / kLog2e);")],
    "no_qk": [(
        """        mma16816<T>(s[2 * np], qa, kb[0], kb[1]);
        mma16816<T>(s[2 * np + 1], qa, kb[2], kb[3]);
""", "")],
    "no_pv": [(
        """        mma16816<T>(o[2 * dn], pa, vb[0], vb[1]);
        mma16816<T>(o[2 * dn + 1], pa, vb[2], vb[3]);
""", "")],
}
SAME_FUNCTION = ("rows32", "philox_twice", "expf")


def patched_source(src, patches):
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"patch text found {src.count(old)} times: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(_build, variants=PATCHES, library="flash_attention"):
    """name -> loaded library of every patched copy of ``variants`` (name ->
    patches) of ``csrc/<library>.cu``, built in parallel."""
    import ctypes
    src = _build.sources()[library].read_text()
    root = _build.BUILD_DIR / "probe"
    root.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, patches in variants.items():
        cu = root / f"{library}_{name}.cu"
        cu.write_text(patched_source(src, patches))
        so = root / f"lib{library}_{name}.so"
        running[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
        cs.log(f"  {name}: " + ", ".join(
            f"{e} {regs} registers, {spill} bytes spill stores"
            for e, (regs, spill) in sorted(cs.ptxas_entries(out).items())
            if "bfloat16" in e))
    return libs


def cases(fa):
    """name -> (kernel, variants, call, plain) at chip_smoke's shapes."""
    out = {}
    for name, (mask, b, h, d) in cs.fwd_shapes().items():
        if name.startswith("dead_rows") or fa.is_wide(d):
            continue
        args, kw = cs.fwd_case(fa, mask, b, h, d, torch.bfloat16, seed=13)
        variants = [v for v in PATCHES
                    if v != "philox_twice" and (v != "rows32" or d == 64)]
        out[f"flash_fwd {name}"] = (
            "flash_fwd_kernel", variants,
            lambda args=args, kw=kw: fa.flash_fwd(*args, **kw),
            lambda args=args, kw=kw: fa.flash_fwd_reference(*args, **kw))
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    for name, (b, strings, stage, h, d) in cs.FLASH_SHAPES.items():
        if fa.is_wide(d):
            continue    # flash_wide_probe.py's
        _, (q, k, v, _), (padded, k_hi, _), tiles = cs.flash_case(
            fa, cs.stage_mask(strings, stage), b, h, d, torch.bfloat16,
            seed=9)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=cs.TRAIN_DROPOUT)
        args = (q, k, v, padded, k_hi, seed)
        variants = [v for v in PATCHES if v != "rows32" or d == 64]
        out[f"flash_fwd_lse {name}"] = (
            "flash_fwd_lse_kernel", variants,
            lambda args=args, kw=kw: fa.flash_fwd_lse(*args, **kw)[0],
            lambda args=args, kw=kw: fa.flash_fwd_lse_reference(
                *args, **kw)[0])
    return out


def time_in_turns(_build, libs, cases, same_function,
                  library="flash_attention"):
    """case -> {library: mean device us, and for each variant of
    ``same_function`` its agreement with the plain version}: every library
    of a case timed in turns (shipped, variants, variants reversed,
    shipped)."""
    shipped = libs["shipped"]
    readings = {}
    try:
        for case, (kernel, variants, call, plain) in cases.items():
            order = ["shipped", *variants]
            times = {}
            for name in order + order[::-1]:
                _build._loaded[library] = libs[name]
                times.setdefault(name, []).append(cs.device_ms(call, kernel))
            row = {name: sum(t) / len(t) * 1e3 for name, t in times.items()}
            want = plain()
            for name in same_function:
                if name in variants:
                    _build._loaded[library] = libs[name]
                    got = call()
                    torch.cuda.synchronize()
                    ok, _, units = cs.rel_gate(got, want, torch.bfloat16)
                    row[f"{name}_eps_units"] = units
                    row[f"{name}_agrees"] = ok
            _build._loaded[library] = shipped
            readings[case] = row
            cs.log(f"  {case:36s} us: " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) and "units" not in k
                else f"{k} {v}" for k, v in row.items()))
    finally:
        _build._loaded[library] = shipped
    return readings


def run(variants, make_cases, same_function, out_name,
        library="flash_attention"):
    """Build the patched copies of ``csrc/<library>.cu``, time them against
    the shipped library at ``make_cases(fa)`` and write the readings to
    OUT_DIR/``out_name``."""
    if not torch.cuda.is_available():
        cs.log(f"no CUDA device: {out_name[:-5]}.py runs on the card only")
        return 2
    from multi_modal_transformers_tokenmerge_torch import _build
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    card = cs.card_line()
    cs.log(card)
    cs.profile_session(lambda: None)
    t0 = time.perf_counter()
    libs = {"shipped": _build.load_library(library),
            **build_variants(_build, variants, library)}
    cs.log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    readings = time_in_turns(_build, libs, make_cases(fa), same_function,
                             library)
    result = {"card": card, "readings_us": readings,
              "guard_records_lost": cs._GUARD["lost"],
              "kernel_sessions_run_again": cs._GUARD["short"]}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, out_name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def main():
    return run(PATCHES, cases, SAME_FUNCTION, "flash_fwd_probe.json")


if __name__ == "__main__":
    sys.exit(main())
