"""Probe of the bf16 tensor-core flash backward on one H100.

    python3 flash_bwd_probe.py

Builds patched copies of ``csrc/flash_attention.cu`` (one ``nvcc`` each, all
at once) and reads the device time of ``flash_dq`` and ``flash_dkv`` under
each beside the shipped library, in turns (shipped, variants, variants
reversed, shipped), with dropout 0.1 at the shapes ``chip_smoke.py`` times
(``FLASH_SHAPES``):

    dkv_recompute      dk/dv at head dim 256: the four warps of a row group
                       each compute the whole S^T and dP^T, no shared pass
    dkv_recompute_ds2  the same with two warps splitting D (twice the
                       accumulators a warp)
    rows32             32-row blocks at head dim 64 (two warps) for dq and
                       dk/dv in place of 64
    philox_each        dk/dv: each lane draws its four Philox counters, no
                       shuffles
    one_pass           dk/dv at head dim 64: the whole 64-query S^T and dP^T
                       at once in place of two passes of 32
    dkv_pass16         dk/dv at head dim 64: four passes of 16 queries
    dq_pass32          dq at head dim 64: two passes of 32 keys in place of
                       the whole 64-key S and dP at once
    blocks4            dq and dk/dv at head dim 64 held to 128 registers, so
                       that four blocks share an SM
    expf               the accurate expf in place of ex2.approx

Each computes the same function and is held against the plain version
(bf16, in units of eps * (1 + |plain|)) and recorded.  Writes every reading
to ``chiprun_out/flash_bwd_probe.json`` and prints it as the last line.
Needs the card and ``nvcc``; the shipped kernels are held by
``chip_smoke.py``.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from flash_fwd_probe import run

_SHARE = "  constexpr bool SHARE_DKV = Traits<D>::DKV_SHARE;\n"
_DKV_WARPS = ("constexpr int RG_DKV = Traits<D>::DKV_RG, "
              "DS_DKV = Traits<D>::DKV_DS;")
# name -> [(text of csrc/flash_attention.cu, its replacement)], each text
# found exactly once
PATCHES = {
    "dkv_recompute": [(_SHARE, "  constexpr bool SHARE_DKV = false;\n")],
    "dkv_recompute_ds2": [
        (_SHARE, "  constexpr bool SHARE_DKV = false;\n"),
        (_DKV_WARPS, _DKV_WARPS.replace("DS_DKV = ",
                                        "DS_DKV = D == 256 ? 2 : "))],
    "rows32": [
        ("constexpr int RG_DQ = Traits<D>::DQ_RG,",
         "constexpr int RG_DQ = D == 64 ? 2 : Traits<D>::DQ_RG,"),
        ("constexpr int RG_DKV = Traits<D>::DKV_RG,",
         "constexpr int RG_DKV = D == 64 ? 2 : Traits<D>::DKV_RG,")],
    "philox_each": [(
        """          const uint32_t key4 =
              static_cast<uint32_t>(k0 + wr + g + 8 * (jj >> 1)) >> 2;
          const uint4 w = philox4x32_10(
              make_uint4(key4, static_cast<uint32_t>(q0 + qc + (jj & 1)),
                         bh + drop.bh0, 0u),
              drop.k0, drop.k1);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          uint32_t got[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t send = pick4(words, jj ^ r);
            got[r] = r ? __shfl_xor_sync(0xffffffffu, send, 4 * r) : send;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) kb[e] = pick4(got, jj ^ e);
""",
        """#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint4 w = philox4x32_10(
                make_uint4(
                    static_cast<uint32_t>(k0 + wr + g + 8 * (e >> 1)) >> 2,
                    static_cast<uint32_t>(q0 + qc + (e & 1)),
                    bh + drop.bh0, 0u),
                drop.k0, drop.k1);
            const uint32_t words[4] = {w.x, w.y, w.z, w.w};
            kb[e] = pick4(words, jj);
          }
""")],
    "one_pass": [("  constexpr int NC = NQ > 4 ? 4 : NQ;",
                  "  constexpr int NC = NQ;")],
    "dkv_pass16": [("  constexpr int NC = NQ > 4 ? 4 : NQ;",
                    "  constexpr int NC = SHARE || NQ <= 2 ? NQ : 2;")],
    "dq_pass32": [("  constexpr int NC = NS;      // ... in a pass",
                   "  constexpr int NC = NS > 4 ? 4 : NS;")],
    "blocks4": [(f"__launch_bounds__(32 * RG * DS)\n    flash_{k}_kernel(",
                 f"__launch_bounds__(32 * RG * DS, D == 64 ? 4 : 1)\n"
                 f"    flash_{k}_kernel(") for k in ("dq", "dkv")],
    "expf": [
        ("    lse2[i] = l * kLog2e;", "    lse2[i] = l;"),
        ("ex2_approx(fmaf(p0, scale2, -lse2[i]))",
         "expf(p0 * a.scale - lse2[i])"),
        ("ex2_approx(fmaf(p1, scale2, -lse2[i]))",
         "expf(p1 * a.scale - lse2[i])"),
        ("on ? ex2_approx(fmaf(s[j][e], scale2, -lq[c] * kLog2e)) : 0.f;",
         "on ? expf(s[j][e] * a.scale - lq[c]) : 0.f;")],
}


def cases(fa):
    """name -> (kernel, variants, call, plain) at chip_smoke's shapes."""
    out = {}
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    for name, (b, strings, stage, h, d) in cs.FLASH_SHAPES.items():
        if fa.is_wide(d):
            continue    # flash_wide_probe.py's
        _, (q, k, v, do), (padded, k_hi, q_lo), tiles = cs.flash_case(
            fa, cs.stage_mask(strings, stage), b, h, d, torch.bfloat16,
            seed=9)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=cs.TRAIN_DROPOUT)
        o, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
        delta = fa.attention_delta(do, o, padded.shape[0])
        dq_args = (q, k, v, do, lse, delta, padded, k_hi, seed)
        dkv_args = (q, k, v, do, lse, delta, padded, q_lo, seed)
        wide = ["rows32", "blocks4"] if d == 64 else []
        out[f"flash_dq {name}"] = (
            "flash_dq_kernel",
            [*wide, *(["dq_pass32"] if wide else []), "expf"],
            lambda a=dq_args, kw=kw: fa.flash_dq(*a, **kw),
            lambda a=dq_args, kw=kw: fa.flash_dq_reference(*a, **kw))
        out[f"flash_dkv {name}"] = (
            "flash_dkv_kernel",
            [*(wide + ["one_pass", "dkv_pass16"] if wide else
               ["dkv_recompute", "dkv_recompute_ds2"]),
             "philox_each", "expf"],
            lambda a=dkv_args, kw=kw: torch.stack(fa.flash_dkv(*a, **kw)),
            lambda a=dkv_args, kw=kw: torch.stack(
                fa.flash_dkv_reference(*a, **kw)))
    return out


def main():
    return run(PATCHES, cases, tuple(PATCHES), "flash_bwd_probe.json")


if __name__ == "__main__":
    sys.exit(main())
