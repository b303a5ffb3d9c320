"""Probe of the bf16 wide flash forwards (head dims above 256) on one H100.

    python3 flash_wide_probe.py

Builds patched copies of ``csrc/flash_attention_wide.cu`` (one ``nvcc``
each, all at once) and reads the device time of ``flash_fwd_lse_wide`` (at
octo_deep_h512's three stages, B=32, 3 heads of 512, dropout 0.1) and of
``flash_fwd_wide`` (the same stages at B=1 and 8, and head dims 320, 576
and 768 at B=8, the first stage) under each beside the shipped library, in
turns (shipped, variants, variants reversed, shipped).  The shipped forward
is the cluster body with wgmma products, TMA copies and the reduce-scatter
exchange; the variants go back along the steps that built it:

    chunked    every head dim on the chunked body (kClusterMaxSlices = 0):
               each slice block recomputes the logits over all of D
    step1      the cluster split on mma.sync products and cp.async copies
    step2      the cluster split on wgmma products and cp.async copies
    allgather  the other exchange: every block stores its partial logits
               in its own shared memory, and after a cluster barrier every
               warp sums the nsl partials of its rows from every block,
               then a second cluster barrier before they are overwritten;
               each block forms the softmax of all its rows

Each computes the same function and is held against the plain version
(bf16, in units of eps * (1 + |plain|)) and recorded.  Writes every reading
to ``chiprun_out/flash_wide_probe.json`` and prints it as the last line.
Needs the card and ``nvcc``; the shipped kernels are held by
``chip_smoke.py``.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from flash_fwd_probe import run

_TILE = """    if (threadIdx.x == 0) {  // this tile's phases: the last ones are done
      for (int i = 0; i < ClusterSmem::owned(nsl); ++i)
        if (rank + i * nsl < 4) mbar_expect(bars + i, nsl * kPartBytes);
      mbar_expect(bars + 2, kPBytes);
    }
"""
# the all-gather exchange in place of the owners' reduce-scatter and the
# all-gather of P (from the tile's partial product to P V)
_GATHER = """    mbar_wait(bars + 4 + st, (kt >> 1) & 1);
    float s[NS][4];
    partial_logits<T>(s, qa, sK + st * kTile, cols);
    float4* mine = sIn + warp * NS * 32 + lane;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mine[j * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    cluster_barrier();
#pragma unroll 1
    for (int r = 0; r < nsl; ++r) {
      const float4* src = peer_shared(mine, r);
      float4 part[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) part[j] = src[j * 32];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (r == 0) {
          s[j][0] = part[j].x, s[j][1] = part[j].y;
          s[j][2] = part[j].z, s[j][3] = part[j].w;
        } else {
          s[j][0] += part[j].x, s[j][1] += part[j].y;
          s[j][2] += part[j].z, s[j][3] += part[j].w;
        }
      }
    }
    cluster_barrier();
    const int8_t* tM = sM + st * kBM * LDM + (wr + g) * LDM + 2 * t;
    float mx[2] = {m[0][0], m[0][1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const char2 live =
            *reinterpret_cast<const char2*>(tM + ii * 8 * LDM + 8 * j);
        s[j][2 * ii] = live.x ? s[j][2 * ii] * a.scale : kNegInf;
        s[j][2 * ii + 1] = live.y ? s[j][2 * ii + 1] * a.scale : kNegInf;
        mx[ii] = fmaxf(mx[ii], fmaxf(s[j][2 * ii], s[j][2 * ii + 1]));
      }
    }
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = quad_max(mx[ii]);
      ref[ii] = fmaxf(mx[ii], 0.5f * kNegInf) * kLog2e;
      alpha[ii] = ex2_approx((m[0][ii] - mx[ii]) * kLog2e);
      m[0][ii] = mx[ii];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2_approx(fmaf(s[j][e], kLog2e, -ref[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      l[0][ii] = l[0][ii] * alpha[ii] + quad_sum(sum[ii]);
    if (DROPOUT && drop.on) {
      const uint32_t row = static_cast<uint32_t>(q0 + wr + g);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t kb4[4];
        row_keep_words(kb4, static_cast<uint32_t>(k0 + 8 * j + 2 * t), row,
                       bh, drop, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = kb4[e] >= drop.threshold ? s[j][e] * drop.inv_keep : 0.f;
      }
    }
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) acc_to_a<T>(pa[kk], s, kk);
    const float2 al = make_float2(alpha[0], alpha[1]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al.x;
      o[n][1] *= al.x;
      o[n][2] *= al.y;
      o[n][3] *= al.y;
    }
    pv_product<T>(o, pa, sV + st * kTile, cols);
"""
_GATHER_END = """  const float2 lw = make_float2(l[0][0], l[0][1]);
  if (lse != nullptr && rank == 0 && t == 0)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      lse[static_cast<size_t>(bh) * a.s_pad + q0 + wr + g + 8 * ii] =
          m[0][ii] + logf(fmaxf(l[0][ii], 1e-30f));
  if (n_k > 0) cluster_barrier();

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = q0 + wr + g + 8 * ii;"""


def _between(src, first, last):
    """The text of ``src`` from ``first`` through ``last`` (each found
    once)."""
    a = src.index(first)
    return src[a:src.index(last, a) + len(last)]


def _allgather(src):
    """The allgather variant's patches against ``src``."""
    tile = _between(src, "    mbar_wait(bars + 4 + st, (kt >> 1) & 1);",
                    "    pv_product<T>(o, pa, sV + st * kTile, cols);\n")
    end = _between(src, "  // the owned rows' sums",
                   "    const int row = q0 + wr + g + 8 * ii;")
    return [(_TILE, ""), (tile, _GATHER), (end, _GATHER_END)]


# step 2 undone: K and V by cp.async, seen by wgmma after a proxy fence
_FENCE = '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
_CP_ASYNC_KV = """    stage_sw128(sK + st * kTile, k + at, kt * kBN, a.seq, row_stride, cols);
    stage_sw128(sV + st * kTile, v + at, kt * kBN, a.seq, row_stride, cols);
"""
# step 1 undone as well: both products on mma.sync fragments
_MMA_QK = """  const int lane = threadIdx.x & 31;
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
_MMA_PV = """  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < kFwdDV / 16; ++n2) {
      if (n2 * 16 < cols) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, tV + sw128(kk * 16 + l8 * 8 + lr, n2 * 16 + l16 * 8));
        mma16816<T>(o[2 * n2], pa[kk], bf[0], bf[1]);
        mma16816<T>(o[2 * n2 + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }
}
"""


def _cp_async(src):
    """Step 2's patches against ``src``: the K and V tiles by cp.async."""
    tma = _between(src, "    if (threadIdx.x == 0) {  // K and V by TMA",
                   "bars + 4 + st);\n      }\n    }\n")
    prologue = "    stage(0);\n    cp_async_commit();\n    cp_async_wait_all();\n"
    tile_end = "    cp_async_wait_all();  // the next tile's mask has landed ...\n"
    return [(tma, _CP_ASYNC_KV),
            ("    mbar_wait(bars + 4 + st, (kt >> 1) & 1);\n", ""),
            (prologue, prologue + _FENCE), (tile_end, tile_end + _FENCE)]


def _mma_sync(src):
    """Step 1's patches against ``src``: step 2's, and both products on
    mma.sync."""
    qk = _between(src, "    int cols) {\n#pragma unroll\n  for (int j = 0;",
                  "  wgmma_commit_wait();\n}\n")
    qk_head = qk[:qk.index("  wgmma_fence();")]
    pv = _between(src, "const T* tV, int cols) {\n",
                  "  wgmma_commit_wait();\n}\n")
    return _cp_async(src) + [(qk, qk_head + _MMA_QK),
                             (pv, "const T* tV, int cols) {\n" + _MMA_PV)]


def _patches():
    """name -> [(text of csrc/flash_attention_wide.cu, its replacement)],
    each text found exactly once."""
    from multi_modal_transformers_tokenmerge_torch import _build
    src = _build.sources()["flash_attention_wide"].read_text()
    return {
        "chunked": [("constexpr int kClusterMaxSlices = 8;",
                     "constexpr int kClusterMaxSlices = 0;")],
        "step1": _mma_sync(src),
        "step2": _cp_async(src),
        "allgather": _allgather(src)}


VARIANTS = ("chunked", "step1", "step2", "allgather")
# name -> (batch, layout strings, stage, heads, head_dim, with LSE)
SHAPES = {**{f"deep_h512_S{s}_B32": (32, cs.DEEP_SPEC, st, 3, 512, True)
             for st, s in enumerate((224, 160, 96))},
          **{f"deep_h512_S{s}_B{b}": (b, cs.DEEP_SPEC, st, 3, 512, False)
             for b in (1, 8) for st, s in enumerate((224, 160, 96))},
          **{f"d{d}_S224_B8": (8, cs.DEEP_SPEC, 0, h, d, False)
             for d, h in ((320, 8), (576, 4), (768, 1))}}


def cases(fa):
    """name -> (kernel, variants, call, plain) at the shapes above."""
    out = {}
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    for name, (b, strings, stage, h, d, lse) in SHAPES.items():
        args, kw = cs.fwd_case(fa, cs.stage_mask(strings, stage), b, h, d,
                               torch.bfloat16, seed=13)
        if lse:
            kw = dict(kw, dropout_rate=cs.TRAIN_DROPOUT)
            out[f"flash_fwd_lse {name}"] = (
                "flash_fwd_lse_wide_kernel", list(VARIANTS),
                lambda a=args, kw=kw: fa.flash_fwd_lse(*a, seed, **kw)[0],
                lambda a=args, kw=kw: fa.flash_fwd_lse_wide_reference(
                    *a, seed, **kw)[0])
        else:
            out[f"flash_fwd {name}"] = (
                "flash_fwd_wide_kernel", list(VARIANTS),
                lambda a=args, kw=kw: fa.flash_fwd(*a, **kw),
                lambda a=args, kw=kw: fa.flash_fwd_wide_reference(*a, **kw))
    return out


def main():
    return run(_patches(), cases, VARIANTS, "flash_wide_probe.json",
               library="flash_attention_wide")


if __name__ == "__main__":
    sys.exit(main())
