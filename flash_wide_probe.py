"""Probe of the bf16 wide flash backward (head dims above 256) on one H100.

    python3 flash_wide_probe.py [phases]

Builds patched copies of ``csrc/flash_attention_wide.cu`` (one ``nvcc``
each, all at once) and reads the device time of ``flash_dq_wide`` and
``flash_dkv_wide`` (dropout 0.1; octo_deep_h512's three stages, B=32, 3
heads of 512, and head dims 320, 576 and 768 at B=8, the first stage) under
each beside the shipped library, in turns (shipped, variants, variants
reversed, shipped).  The shipped backward is the cluster body with wgmma
products, TMA copies, the reduce-scatter of partial S and dP and, where two
exchange buffers fit, the next tile's partials sent while this tile's
fragments travel; the variants go back along the steps that built it:

    chunked    every head dim on the chunked bodies (kBwdClusterMaxSlices
               = 0): each slice block recomputes S and dP over all of D,
               restaging its operands from L2 every 32 (dq) or 64 (dk/dv)
               columns; the bodies the backward ran before the cluster
    step1      the cluster split on mma.sync products and cp.async copies
    step2      the cluster split on wgmma products and cp.async copies
    one_buffer one exchange buffer at every head dim: a tile's partials
               leave only once the last tile's fragments have come

(step1's mma.sync products replace the forwards' wgmma too; only the
backward is timed.)  Each computes the same function and is held against
the plain version (bf16, in units of eps * (1 + |plain|), dq and dK, dV
together) and recorded.  Writes every reading to
``chiprun_out/flash_wide_probe.json`` and prints it as the last line.
With ``phases``, builds one more copy whose cluster backward reads the SM
clock at the marks of ``PHASES`` and reports where one block's time goes,
phase by phase, into ``chiprun_out/flash_wide_probe_phases.json``.
Needs the card and ``nvcc``; the shipped kernels are held by
``chip_smoke.py``.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from flash_fwd_probe import run

# step 2 undone: the streamed tiles by cp.async from every thread, waited
# for and fenced (wgmma reads through the async proxy) where the TMA
# barrier was awaited
_FENCE = '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
_CP_ASYNC = """  auto stage_tiles = [&](int i) {
    const int st = i & 1, o0 = (first + i) * kBN;
    stage_sw128<T, kBwdNT>(sA + st * kTile, (DKV ? q : k) + at, o0, a.seq,
                           row_stride, cols);
    stage_sw128<T, kBwdNT>(sB + st * kTile, (DKV ? dout : v) + at, o0, a.seq,
                           row_stride, cols);
    cp_async_commit();
  };
"""
# step 1 undone as well: every product on mma.sync fragments
_MMA_PARTIAL = """  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kFwdDV / 16; ++kk) {
    if (kk * 16 < cols) {
#pragma unroll
      for (int n2 = 0; n2 < kBN / 16; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, tK + sw128(n2 * 16 + l16 * 8 + lr, kk * 16 + l8 * 8));
        mma16816<T>(s[2 * n2], qa[kk], bf[0], bf[1]);
        mma16816<T>(s[2 * n2 + 1], qa[kk], bf[2], bf[3]);
      }
    }
  }
}
"""
_MMA_OUT = """  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < NO / 2; ++n2) {
      if (n2 * 16 < cols) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, tB + sw128(kk * 16 + l8 * 8 + lr, n2 * 16 + l16 * 8));
        mma16816<T>(o[2 * n2], pa[kk], bf[0], bf[1]);
        mma16816<T>(o[2 * n2 + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }
}
"""


def _between(src, first, last):
    """The text of ``src`` from ``first`` through ``last`` (each found
    once)."""
    a = src.index(first)
    return src[a:src.index(last, a) + len(last)]


def _cp_async(src):
    """Step 2's patches against ``src``: the backward's streamed tiles by
    cp.async."""
    tma = _between(src, "  auto stage_tiles = [&](int i) {",
                   "bars + 6 + st);\n    }\n  };\n")
    return [(tma, _CP_ASYNC),
            ("    if (threadIdx.x == 0) stage_tiles(0);\n",
             "    stage_tiles(0);\n"),
            (_between(src, "    if (threadIdx.x == 0 && n > 1) {",
                      "      stage_tiles(1);\n    }\n"),
             "    if (n > 1) stage_tiles(1);\n"),
            ("    if (threadIdx.x == kNT && i + 2 < n) stage_tiles(i + 2);\n",
             "    if (i + 2 < n) stage_tiles(i + 2);\n"),
            ("    mbar_wait(bars + 6 + st, (i >> 1) & 1);\n",
             "    cp_async_wait_all();\n" + _FENCE + "    __syncthreads();\n")]


def _mma_sync(src):
    """Step 1's patches against ``src``: step 2's, and the partial and
    output products on mma.sync."""
    partial = _between(src, "    int cols) {\n#pragma unroll\n  for (int j = 0;",
                       "  wgmma_commit_wait();\n}\n")
    head = partial[:partial.index("  wgmma_fence();")]
    out = _between(src, "const T* tB, int cols) {\n",
                   "  wgmma_commit_wait();\n}\n")
    return _cp_async(src) + [(partial, head + _MMA_PARTIAL),
                             (out, "const T* tB, int cols) {\n" + _MMA_OUT)]


def _patches():
    """name -> [(text of csrc/flash_attention_wide.cu, its replacement)],
    each text found exactly once."""
    from multi_modal_transformers_tokenmerge_torch import _build
    src = _build.sources()["flash_attention_wide"].read_text()
    return {
        "chunked": [("constexpr int kBwdClusterMaxSlices = kClusterMaxSlices;",
                     "constexpr int kBwdClusterMaxSlices = 0;")],
        "step1": _mma_sync(src),
        "step2": _cp_async(src),
        "one_buffer": [(
            "    return bytes(nsl, nf, 2) <= kMaxSmem ? 2 : 1;",
            "    return 1;")]}


VARIANTS = ("chunked", "step1", "step2", "one_buffer")
# name -> (batch, layout strings, stage, heads, head_dim)
SHAPES = {**{f"deep_h512_S{s}_B32": (32, cs.DEEP_SPEC, st, 3, 512)
             for st, s in enumerate((224, 160, 96))},
          **{f"d{d}_S224_B8": (8, cs.DEEP_SPEC, 0, h, d)
             for d, h in ((320, 8), (576, 4), (768, 1))}}


def cases(fa):
    """name -> (kernel, variants, call, plain) at the shapes above."""
    out = {}
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    for name, (b, strings, stage, h, d) in SHAPES.items():
        _, (q, k, v, do), (padded, k_hi, q_lo), tiles = cs.flash_case(
            fa, cs.stage_mask(strings, stage), b, h, d, torch.bfloat16,
            seed=9)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=cs.TRAIN_DROPOUT)
        o, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
        args = (q, k, v, do, lse, fa.attention_delta(do, o, padded.shape[0]),
                padded)
        out[f"flash_dq {name}"] = (
            "flash_dq_wide_kernel", list(VARIANTS),
            lambda a=args, t=k_hi, kw=kw: fa.flash_dq(*a, t, seed, **kw),
            lambda a=args, t=k_hi, kw=kw: fa.flash_dq_wide_reference(
                *a, t, seed, **kw))
        out[f"flash_dkv {name}"] = (
            "flash_dkv_wide_kernel", list(VARIANTS),
            lambda a=args, t=q_lo, kw=kw: torch.cat(
                fa.flash_dkv(*a, t, seed, **kw)),
            lambda a=args, t=q_lo, kw=kw: torch.cat(
                fa.flash_dkv_wide_reference(*a, t, seed, **kw)))
    return out


# python3 flash_wide_probe.py phases: where a cluster block's time goes.
# A copy of the source whose cluster backward reads the SM clock at each
# mark below (label, text of the source, the mark before or after it); a
# phase is the time from the mark before it to its own, summed over a
# block's tiles.  One block of each kernel (a row tile with four tiles of
# the other axis), both warpgroups' first threads.
PHASES = (
    ("prologue", "  cluster_wait();\n", "after"),
    ("ring tile waited", "    mbar_wait(bars + 6 + st, (i >> 1) & 1);\n",
     "after"),
    ("partial product", "    partial_logits<T>(s, xa, (wg ? sB : sA) + st *"
     " kTile, cols);\n", "after"),
    ("partial stored", "               make_float4(s[j][0], s[j][1], s[j][2],"
     " s[j][3]), bar);\n    }\n  };\n", "end"),
    ("partials arrived", "      mbar_wait(bars + 2 * buf(i) + s2, parity(i));"
     "\n", "after"),
    ("partials summed", "      // element e: row (of the own axis)", "before"),
    ("dS (and P) formed", "      // the halves of fragment (grp", "before"),
    ("fragments stored", "    if (pipe && i + 1 < n) send_partial(i + 1);\n",
     "before"),
    ("fragments arrived", "    mbar_wait(bars + 4 + buf(i), parity(i));\n",
     "after"),
    ("fragments loaded", "    if (!pipe && i + 1 < n) send_partial(i + 1);\n",
     "before"),
    ("output product", "    cp_async_wait_all();  // the next tile's mask "
     "(and", "before"),
    ("tile end", "    if (threadIdx.x == kNT && i + 2 < n) stage_tiles(i + 2);"
     "\n", "after"),
    ("block end", "  // dq: dQ (warpgroup 0); dk/dv: dV", "before"))
_STAMPS = 96


def _phase_patches():
    """The clock-reading copy's patches: the marks, the buffer they fill
    (one block of each kernel: rank 0 of row tile 1 in dq, of row tile 0 in
    dk/dv; head 0, batch row 7) and a reader of it."""
    def mark(label):
        return (f"    if (ns < {_STAMPS}) {{ stamp[ns] = clock64(); "
                f"tag[ns++] = {label}; }}\n")
    patches = [
        ("constexpr int kBwdClusterMaxSlices",
         f"__device__ long long g_stamps[2][2][2][{_STAMPS}];\n"
         "constexpr int kBwdClusterMaxSlices"),
        ("  const float scale2 = a.scale * kLog2e;\n  // tile i's exchange",
         f"  const float scale2 = a.scale * kLog2e;\n  long long stamp"
         f"[{_STAMPS}]; int tag[{_STAMPS}]; int ns = 0;\n" + mark(-1)
         + "  // tile i's exchange")]
    for label, (_, text, where) in enumerate(PHASES):
        if where == "after":
            patches.append((text, text + mark(label)))
        elif where == "before":
            patches.append((text, mark(label) + text))
        else:  # the end of a lambda: before its closing brace
            body = text[:-len("  };\n")]
            patches.append((text, body + mark(label) + "  };\n"))
    text = PHASES[-1][1]  # "before": the buffer filled after the mark
    patches[-1] = (text, mark(len(PHASES) - 1) + (
        "  if (blockIdx.x == (DKV ? 0 : nsl) && blockIdx.y == 0 && "
        "blockIdx.z == 7 && (threadIdx.x & 127) == 0)\n"
        "    for (int j = 0; j < ns; ++j) {\n"
        "      g_stamps[DKV][threadIdx.x >> 7][0][j] = stamp[j];\n"
        "      g_stamps[DKV][threadIdx.x >> 7][1][j] = tag[j];\n"
        "    }\n") + text)
    patches.append(('}  // extern "C"',
                    "int flash_wide_read_stamps(long long* out) {\n"
                    "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                    "      out, g_stamps, sizeof(g_stamps)));\n}\n\n"
                    '}  // extern "C"'))
    return patches


def phases():
    """Where the time of one cluster block goes, by phase: dq and dk/dv at
    octo_deep_h512's first stage (bf16, B=32, dropout 0.1), in SM cycles
    and in us at the SM clock nvidia-smi reads after the runs."""
    import ctypes
    import json
    import os
    import subprocess
    from flash_fwd_probe import build_variants
    from multi_modal_transformers_tokenmerge_torch import _build
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    if not torch.cuda.is_available():
        cs.log("no CUDA device: flash_wide_probe.py runs on the card only")
        return 2
    card = cs.card_line()
    cs.log(card)
    lib = build_variants(_build, {"phases": _phase_patches()},
                         "flash_attention_wide")["phases"]
    _build._loaded["flash_attention_wide"] = lib
    b, strings, stage, h, d = cs.WIDE_FLASH_SHAPES["deep_h512_S224"]
    _, (q, k, v, do), (padded, k_hi, q_lo), tiles = cs.flash_case(
        fa, cs.stage_mask(strings, stage), b, h, d, torch.bfloat16, seed=9)
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    kw = dict(block_q=tiles[0], block_k=tiles[1],
              dropout_rate=cs.TRAIN_DROPOUT)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
    delta = fa.attention_delta(do, out, padded.shape[0])
    for _ in range(5):
        fa.flash_dq(q, k, v, do, lse, delta, padded, k_hi, seed, **kw)
        fa.flash_dkv(q, k, v, do, lse, delta, padded, q_lo, seed, **kw)
    torch.cuda.synchronize()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()
    mhz = float(clock[0]) if clock else float("nan")
    buf = (ctypes.c_longlong * (2 * 2 * 2 * _STAMPS))()
    lib.flash_wide_read_stamps.argtypes = [ctypes.c_void_p]
    if lib.flash_wide_read_stamps(ctypes.addressof(buf)) != 0:
        cs.fail("reading the stamps failed")
    names = [p[0] for p in PHASES]
    result = {"card": card, "sm_clock_mhz": mhz, "tiles": {
        "dq": int(k_hi[1]), "dkv": int(padded.shape[0] // 64 - q_lo[0])}}
    for kind, kernel in enumerate(("dq", "dkv")):
        for wg in range(2):
            at = ((kind * 2 + wg) * 2) * _STAMPS
            stamps = list(buf[at:at + _STAMPS])
            tags = list(buf[at + _STAMPS:at + 2 * _STAMPS])
            cycles = dict.fromkeys(names, 0)
            for j in range(1, _STAMPS):
                if tags[j] < 0 or stamps[j] == 0:
                    break
                cycles[names[tags[j]]] += stamps[j] - stamps[j - 1]
            total = sum(cycles.values())
            result[f"{kernel} warpgroup {wg}"] = {
                "cycles": cycles, "total_cycles": total,
                "total_us": total / mhz}
            cs.log(f"  {kernel} warpgroup {wg}: {total} cycles "
                   f"({total / mhz:.2f} us at {mhz:.0f} MHz): " + ", ".join(
                       f"{n} {c}" for n, c in cycles.items()))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "flash_wide_probe_phases.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def main():
    if sys.argv[1:] == ["phases"]:
        return phases()
    return run(_patches(), cases, VARIANTS, "flash_wide_probe.json",
               library="flash_attention_wide")


if __name__ == "__main__":
    sys.exit(main())
