"""Card-only probe of the wide DDPM sampler kernel (csrc/ddpm_sampler_wide.cu).

    python3 sampler_wide_probe.py

Builds the shipped source, the body it replaced (carried below as
BARRIER_BODY: 256 threads a block, the partial sums stored into every block
and a cluster barrier a step, 2-byte loads of rows whose lane groups share
banks) and patched copies of both, one nvcc
each, all at once, and times each in turns with the shipped kernel
(shipped first and last), with CUDA events around direct launches, at
octo_base_chunk28's sampler (bf16 DDPM, T=100, H=3072, A=28; B=1, 8 and
64) and at octo_base's (T=32, H=768, A=8, B=1).  Copies:

- barrier_body: the body the shipped one replaced;
- barrier_skeleton: that body without its products (its loop's skeleton);
- no_mbarrier: the shipped kernel with its partial sums stored into every
  block and a cluster barrier a step, in place of st.async on each block's
  barrier (the exchange step left out);
- threads256: the shipped kernel at 256 threads a block, the first
  product in two passes at octo_base_chunk28 (the one-pass step left out);
- no_bulk: the shipped kernel with the ring's stages copied by every
  thread's cp.async, in place of one thread's cp.async.bulk a row (the
  bulk-copy step left out);
- no_first, no_second: the shipped kernel without the first product's or
  the second product's sums (timed only: what each product costs);
- floor: the shipped kernel without its products and its ring (the
  contexts unread, the noise read from device memory): the step chain's
  exchange (st.async, the barrier's wait), the update and the block's two
  barriers alone, the design's latency floor.

Every copy that computes the sampler (all but the timed-only ones) is
held bit for bit against barrier_body: the shipped kernel runs its sums
in the same order.  Writes chiprun_out/sampler_wide_probe.json; run it
after chip_smoke.py in one call to reuse the built library, or alone.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs

# the second product's count of terms a lane
_COUNT = ("          const int cnt = lane < units ? ((units - 1 - lane) >> lg2) "
          "+ 1 : 0;")
# the shipped source's text -> its replacement, each found exactly once
PATCHES = {
    "no_mbarrier": [("  const bool exchange = p.expect > 0;\n",
                     "  const bool exchange = false;\n")],
    "threads256": [("constexpr int kThreads = 384;",
                    "constexpr int kThreads = 256;")],
    "no_first": [("            for (int k0 = 0; k0 < A; k0 += Vec<T>::N) {",
                  "            for (int k0 = A; k0 < A; k0 += Vec<T>::N) {")],
    "no_second": [(_COUNT, "          const int cnt = 0;")],
    "no_bulk": [("  p.bulk = (p.flags & kRing) && (H * elem) % 16 == 0 &&",
                 "  p.bulk = false && (H * elem) % 16 == 0 &&")],
    "floor": [("      for (int n0 = 0; n0 < units; n0 += kThreads >> lg1) {",
               "      for (int n0 = 0; n0 < 0; n0 += kThreads >> lg1) {"),
              (_COUNT, "          const int cnt = 0;"),
              ("  const bool ring = FAST || (p.flags & kRing);\n",
               "  const bool ring = false;\n")],
}
# BARRIER_BODY's text -> its replacement
BARRIER_PATCHES = {
    "barrier_skeleton": [("        if (n < units) {\n",
                          "        if (false) {\n"),
                         ("        if (a < A) {\n", "        if (false) {\n")],
}
TIMED_ONLY = ("floor", "barrier_skeleton", "no_first", "no_second")
# (label, T, B, H, A)
SHAPES = [("chunk28 T=100 B=1", 100, 1, 3072, 28),
          ("chunk28 T=100 B=8", 100, 8, 3072, 28),
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
    """name -> loaded library of every source text, one nvcc each, in
    parallel (csrc/ on the include path for cluster.cuh)."""
    root = _build.BUILD_DIR / "probe"
    root.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, text in sources.items():
        cu = root / f"sampler_wide_{name}.cu"
        cu.write_text(text)
        so = root / f"libsampler_wide_{name}.so"
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
            for e, (regs, spill) in sorted(
                cs.ptxas_entries(out, ("ddpm_sampler_wide",)).items())
            if "bfloat16, 0, true" in e))
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
    return call, plan, out


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
    libs = build(_build, {
        "shipped": src, "barrier_body": BARRIER_BODY,
        **{k: patched(src, p) for k, p in PATCHES.items()},
        **{k: patched(BARRIER_BODY, p) for k, p in BARRIER_PATCHES.items()}})
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
        same = {}
        for name, (call, _, out) in calls.items():
            call()
        torch.cuda.synchronize()
        want = calls["barrier_body"][2]
        for name, (_, _, out) in calls.items():
            if name not in TIMED_ONLY:
                same[name] = bool(torch.equal(out, want))
        readings[label] = {"us": row, "us_a_step": {
            n: v / t for n, v in row.items()},
            "bit_for_bit_with_barrier_body": same, "plans": {
                n: calls[n][1] for n in ("shipped", "barrier_body")}}
        cs.log(f"  {label} us: {row}; bit for bit: {same}")
        if not all(same.values()):
            raise SystemExit(f"{label}: a copy disagrees with barrier_body: "
                             f"{same}")
    result = {"card": card, "readings": readings}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "sampler_wide_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


# The body the shipped kernel replaced: csrc/ddpm_sampler_wide.cu as it was,
# less its header note.
BARRIER_BODY = r"""// The wide sampler's earlier body: 256 threads a block, a cluster barrier
// a step, the ring issued every step.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 256;      // threads of a block
constexpr int kMaxRows = 8;        // batch rows a block takes at most
constexpr int kMaxCluster = 8;     // blocks of a cluster (the portable most)
constexpr int kStages = 4;         // ring stages: 3 steps in flight
constexpr long long kSmemBudget = 232448;   // a block's shared memory
// the weights a block should hold at most when choosing the cluster size
constexpr long long kWeightShare = 160 * 1024;
constexpr int kMaxGridY = 65535;

enum Mode { kDDPM = 0, kDDIMRaw = 1, kDDIMRecompute = 2 };
// the buffers placed in shared memory
enum Placed {
  kPart = 1, kState = 2, kHidden = 4, kBias = 8, kRing = 16, kWeights = 32,
  kAll = 63
};

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_f(float x) {
    return __float2half_rn(x);
  }
};

// round a float32 value to the compute dtype and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

__host__ __device__ __forceinline__ long long align16(long long n) {
  return (n + 15) & ~15LL;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// How a launch is cut; computed on the host from the shape alone.
struct Plan {
  int clusters;    // C: blocks of a cluster, splitting the hidden units
  int units;       // U: hidden units of a block (the last may have fewer)
  int rows;        // R: batch rows of a block, a power of two
  int groups;      // row groups (clusters along the grid's y)
  int grid_y;      // min(groups, kMaxGridY); a block loops over the rest
  int lg1, lg2;    // log2 of the lanes sharing one sum, first / second
  int flags;       // Placed: the buffers in shared memory
  int smem;        // dynamic shared memory of a block, bytes
  // byte offsets in shared memory
  int off_part, off_state, off_hidden, off_bias, off_ring, off_wn, off_wo;
  int stage_bytes, stage_noise;   // a ring stage: contexts, then noise
  // float offsets in a block's scratch, and its floats
  long long scr_part, scr_state, scr_hidden, scr_block;
};

// log2 of the lanes sharing one sum of k terms for n outputs: the largest
// power of two g <= 32 with g * n <= kThreads and g <= k
int lanes_log2(long long n, long long k) {
  int lg = 0;
  while (lg < 5 && (2LL << lg) * n <= kThreads && (2LL << lg) <= k) ++lg;
  return lg;
}

Plan make_plan(int steps, int batch, int hidden, int adim, int elem,
               int mode, int sms) {
  Plan p = {};
  const long long H = hidden, A = adim;
  const long long wbytes = 2 * H * A * elem;
  long long c = ceil_div(H, kThreads);
  if (ceil_div(wbytes, kWeightShare) > c) c = ceil_div(wbytes, kWeightShare);
  if (c > kMaxCluster) c = kMaxCluster;
  p.units = int(ceil_div(ceil_div(H, c), 8) * 8);
  p.clusters = int(ceil_div(H, p.units));
  p.lg1 = lanes_log2(p.units, A);
  p.lg2 = lanes_log2(A, p.units);
  const long long slots = sms / p.clusters > 0 ? sms / p.clusters : 1;
  const long long r = ceil_div(batch, slots);
  p.rows = 1;
  while (p.rows < kMaxRows && p.rows < r) p.rows *= 2;
  p.groups = int(ceil_div(batch, p.rows));
  p.grid_y = p.groups < kMaxGridY ? p.groups : kMaxGridY;

  const long long R = p.rows, U = p.units;
  p.stage_noise = int(align16(R * U * elem));
  const long long stage =
      p.stage_noise + align16(mode == kDDPM ? R * A * 4 : 0);
  long long used = 0;
  auto place = [&](int flag, long long bytes, int* off) {
    if (used + align16(bytes) > kSmemBudget) return false;
    *off = int(used);
    used += align16(bytes);
    p.flags |= flag;
    return true;
  };
  place(kPart, 2 * p.clusters * R * A * 4, &p.off_part);
  place(kState, 2 * R * A * 4, &p.off_state);
  place(kHidden, R * U * 4, &p.off_hidden);
  place(kBias, (U + A) * 4, &p.off_bias);
  if (stage <= kSmemBudget && place(kRing, kStages * stage, &p.off_ring))
    p.stage_bytes = int(stage);
  if (place(kWeights, align16(U * A * elem) + A * U * elem, &p.off_wn))
    p.off_wo = int(p.off_wn + align16(U * A * elem));
  p.smem = int(used);

  long long scr = 0;
  if (!(p.flags & kPart)) { p.scr_part = scr; scr += 2 * p.clusters * R * A; }
  if (!(p.flags & kState)) { p.scr_state = scr; scr += 2 * R * A; }
  if (!(p.flags & kHidden)) { p.scr_hidden = scr; scr += R * U; }
  p.scr_block = scr;
  return p;
}

// Copy n elements from global to shared memory: cp.async in 16-byte chunks
// where both share their 16-byte alignment, else in 4-byte chunks where
// they share 4; elements outside whole chunks one by one.  The caller
// commits and waits.  The loops stay rolled: this runs inside the step
// loop, whose code has to stay small.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int n,
                                          int tid) {
  const int s = int(reinterpret_cast<uintptr_t>(src) & 15);
  const int d = int(reinterpret_cast<uintptr_t>(dst) & 15);
  const int g = s == d ? 16 : ((s & 3) == (d & 3) ? 4 : 0);
  int head = n, body = 0, per = 1;
  if (g) {
    per = g / int(sizeof(T));
    head = ((g - s % g) % g) / int(sizeof(T));
    if (head > n) head = n;
    body = (n - head) / per;
  }
#pragma unroll 1
  for (int i = tid; i < head; i += kThreads) dst[i] = src[i];
  if (g == 16) {
#pragma unroll 1
    for (int k = tid; k < body; k += kThreads)
      __pipeline_memcpy_async(dst + head + k * per, src + head + k * per, 16);
  } else if (g == 4) {
#pragma unroll 1
    for (int k = tid; k < body; k += kThreads)
      __pipeline_memcpy_async(dst + head + k * per, src + head + k * per, 4);
  }
#pragma unroll 1
  for (int i = head + body * per + tid; i < n; i += kThreads) dst[i] = src[i];
}

// v summed over the 2^lg lanes that share it (a power-of-two group of a
// warp); lane (l & ~(2^lg - 1)) holds the sum
__device__ __forceinline__ float lane_sum(float v, int lg) {
#pragma unroll 1
  for (int off = (1 << lg) >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// FAST: every buffer in shared memory (p.flags == kAll), so that every
// pointer below is known to be shared and the loads are ld.shared.  ROWS:
// the batch rows of a block, a power of two; a group with fewer rows (the
// batch's last) computes its missing rows on stale data and writes none
// of them.
template <typename T, int MODE, bool FAST, int ROWS>
__global__ void __launch_bounds__(kThreads)
ddpm_sampler_wide_kernel(const float* __restrict__ noisy,   // (B, A)
                         const T* __restrict__ ctx,         // (T, B, H)
                         const float* __restrict__ noise,   // (T, B, A)
                         const float* __restrict__ coeffs,  // (T, 3|4)
                         const T* __restrict__ wn,          // (H, A)
                         const T* __restrict__ bn,          // (H)
                         const T* __restrict__ wo,          // (A, H)
                         const T* __restrict__ bo,          // (A)
                         float* __restrict__ out,           // (B, A)
                         float* __restrict__ scratch,
                         int steps, int batch, int hidden, int adim,
                         float clip_value, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ncoef = MODE == kDDPM ? 3 : 4;
  const int tid = threadIdx.x;
  const int C = p.clusters, U = p.units, A = adim;
  const int c = blockIdx.x;   // the block's rank in its cluster
  const int j0 = c * U;
  const int units = hidden - j0 < U ? hidden - j0 : U;
  const bool part_s = FAST || (p.flags & kPart);
  const bool state_s = FAST || (p.flags & kState);
  const bool hidden_s = FAST || (p.flags & kHidden);
  const bool bias_s = FAST || (p.flags & kBias);
  const bool ring = FAST || (p.flags & kRing);
  const bool wres = FAST || (p.flags & kWeights);

  float* scr = scratch + (size_t(blockIdx.y) * C + c) * size_t(p.scr_block);
  // partial sums [2][C][ROWS][A]: block k writes slot k of every block's
  float* part = part_s ? reinterpret_cast<float*>(smem + p.off_part)
                       : scr + p.scr_part;
  float* state = state_s ? reinterpret_cast<float*>(smem + p.off_state)
                         : scr + p.scr_state;
  float* xf = state;                        // [ROWS][A] float32 sample
  float* xr = state + size_t(ROWS) * A;     // [ROWS][A] its rounding
  float* hs = hidden_s ? reinterpret_cast<float*>(smem + p.off_hidden)
                       : scr + p.scr_hidden;   // [ROWS][U]
  float* bn_s = reinterpret_cast<float*>(smem + p.off_bias);    // [U]
  float* bo_s = bn_s + U;                                       // [A]
  // the block's weights: Wn rows j0 .. j0 + units, row stride A; Wo columns
  // j0 .. j0 + units of each action's row, row stride wo_rs
  const T* wn_p = wres ? reinterpret_cast<const T*>(smem + p.off_wn)
                       : wn + size_t(j0) * A;
  const T* wo_p = wres ? reinterpret_cast<const T*>(smem + p.off_wo)
                       : wo + j0;
  const size_t wo_rs = wres ? size_t(U) : size_t(hidden);
  const size_t slot = size_t(ROWS) * A;     // one block's partial sums
  const size_t half = size_t(C) * slot;     // one of the two buffers

  if (wres) {
    T* wn_s = reinterpret_cast<T*>(smem + p.off_wn);
    T* wo_s = reinterpret_cast<T*>(smem + p.off_wo);
    copy_span(wn_s, wn + size_t(j0) * A, units * A, tid);
#pragma unroll 1
    for (int a = 0; a < A; ++a)
      copy_span(wo_s + size_t(a) * U, wo + size_t(a) * hidden + j0, units,
                tid);
  }
  if (bias_s) {
    for (int n = tid; n < units; n += kThreads)
      bn_s[n] = Cvt<T>::to_f(bn[j0 + n]);
    for (int a = tid; a < A; a += kThreads) bo_s[a] = Cvt<T>::to_f(bo[a]);
  }

  const int lg1 = p.lg1, lg2 = p.lg2;
  const int g1 = 1 << lg1, g2 = 1 << lg2;
#pragma unroll 1
  for (int grp = blockIdx.y; grp < p.groups; grp += gridDim.y) {
    const int r0 = grp * ROWS;
    const int rows = batch - r0 < ROWS ? batch - r0 : ROWS;
    const int pairs = rows * A;

    // stage s of the ring: its rows' contexts and noise
    const auto issue = [&](int s) {
      if (!ring || s >= steps) return;
      unsigned char* st = smem + p.off_ring + (s % kStages) * p.stage_bytes;
#pragma unroll 1
      for (int r = 0; r < rows; ++r)
        copy_span(reinterpret_cast<T*>(st) + size_t(r) * U,
                  ctx + (size_t(s) * batch + r0 + r) * hidden + j0, units,
                  tid);
      if (MODE == kDDPM)
        copy_span(reinterpret_cast<float*>(st + p.stage_noise),
                  noise + (size_t(s) * batch + r0) * A, pairs, tid);
    };
    for (int i = tid; i < ROWS * A; i += kThreads) {
      const float x = i < pairs ? noisy[size_t(r0) * A + i] : 0.f;
      xf[i] = x;
      xr[i] = rnd<T>(x);
    }
#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) {
      issue(s);
      __pipeline_commit();
    }
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();

#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      issue(t + kStages - 1);
      __pipeline_commit();
      // this step's coefficients, read now and used after both products
      const float* cf = coeffs + size_t(t) * ncoef;
      const float c0 = __ldg(cf), c1 = __ldg(cf + 1), c2 = __ldg(cf + 2);
      const float c3 = MODE == kDDPM ? 0.f : __ldg(cf + ncoef - 1);
      const unsigned char* st =
          smem + p.off_ring + (t % kStages) * p.stage_bytes;
      const T* ctx_t = ring ? reinterpret_cast<const T*>(st)
                            : ctx + (size_t(t) * batch + r0) * hidden + j0;
      const size_t ctx_rs = ring ? size_t(U) : size_t(hidden);

      // h[r][n] = relu(cd(cd(cd(x[r] . Wn[n]) + bn[n]) + ctx[t][r][n]))
#pragma unroll 1
      for (int n0 = 0; n0 < units; n0 += kThreads >> lg1) {
        const int n = n0 + (tid >> lg1);
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
        if (n < units) {
          const T* w = wn_p + size_t(n) * A;
#pragma unroll 4
          for (int k = tid & (g1 - 1); k < A; k += g1) {
            const float wv = Cvt<T>::to_f(w[k]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r] = fmaf(xr[r * A + k], wv, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = lane_sum(acc[r], lg1);
        if ((tid & (g1 - 1)) == 0 && n < units) {
          const float b = bias_s ? bn_s[n] : Cvt<T>::to_f(bn[j0 + n]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float h = rnd<T>(rnd<T>(acc[r]) + b);
            const float cv = r < rows ? Cvt<T>::to_f(ctx_t[r * ctx_rs + n])
                                      : 0.f;
            hs[r * U + n] = fmaxf(rnd<T>(h + cv), 0.f);
          }
        }
      }
      __syncthreads();

      // the block's partial eps[r][a] = sum over its units of h . Wo[a],
      // written into slot c of every block of the cluster
      const size_t buf = (t & 1) * half + size_t(c) * slot;
#pragma unroll 1
      for (int a0 = 0; a0 < A; a0 += kThreads >> lg2) {
        const int a = a0 + (tid >> lg2);
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
        if (a < A) {
          const T* w = wo_p + size_t(a) * wo_rs;
#pragma unroll 4
          for (int k = tid & (g2 - 1); k < units; k += g2) {
            const float wv = Cvt<T>::to_f(w[k]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r] = fmaf(hs[r * U + k], wv, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = lane_sum(acc[r], lg2);
        if ((tid & (g2 - 1)) == 0 && a < A) {
#pragma unroll 1
          for (int k = 0; k < C; ++k) {
            float* dst = part_s ? peer_shared(part, k)
                                : scratch + (size_t(blockIdx.y) * C + k) *
                                      size_t(p.scr_block) + p.scr_part;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) dst[buf + r * A + a] = acc[r];
          }
        }
      }
      if (C > 1)
        cluster_barrier();
      else
        __syncthreads();

      // eps = the cluster's partials in rank order; the update
      const float* nz =
          MODE != kDDPM ? nullptr
          : ring ? reinterpret_cast<const float*>(st + p.stage_noise)
                 : noise + (size_t(t) * batch + r0) * A;
      const float* pr = part + (t & 1) * half;
#pragma unroll 1
      for (int i = tid; i < pairs; i += kThreads) {
        float e = 0.f;
#pragma unroll 1
        for (int k = 0; k < C; ++k)
          e += part_s ? pr[k * slot + i] : __ldcg(pr + k * slot + i);
        const int a = i % A;
        const float b = bias_s ? bo_s[a] : Cvt<T>::to_f(bo[a]);
        float eps = rnd<T>(rnd<T>(e) + b);
        const float x = xf[i];
        float nx;
        if (MODE == kDDPM) {
          nx = c0 * (x - c1 * eps) + c2 * nz[i];
        } else {
          const float x0 = fminf(fmaxf(c0 * x - c1 * eps, -clip_value),
                                 clip_value);
          if (MODE == kDDIMRecompute) eps = (c0 * x - x0) / c1;
          nx = c2 * x0 + c3 * eps;
        }
        nx = fminf(fmaxf(nx, -clip_value), clip_value);
        xf[i] = nx;
        xr[i] = rnd<T>(nx);
      }
      __pipeline_wait_prior(kStages - 2);
      __syncthreads();
    }

    if (c == 0)
      for (int i = tid; i < pairs; i += kThreads)
        out[size_t(r0) * A + i] = xf[i];
    // every block has read the last step's partial sums before any starts
    // the next row group (writing into the others) or leaves
    if (C > 1) cluster_barrier();
  }
}

template <typename T, int MODE, bool FAST, int ROWS>
cudaError_t launch_plan(const Plan& p, const void* noisy, const void* ctx,
                        const void* noise, const void* coeffs, const void* wn,
                        const void* bn, const void* wo, const void* bo,
                        void* out, void* scratch, int steps, int batch,
                        int hidden, int adim, float clip_value,
                        cudaStream_t stream) {
  auto kernel = ddpm_sampler_wide_kernel<T, MODE, FAST, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters, p.grid_y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = size_t(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(noisy),
      static_cast<const T*>(ctx), static_cast<const float*>(noise),
      static_cast<const float*>(coeffs), static_cast<const T*>(wn),
      static_cast<const T*>(bn), static_cast<const T*>(wo),
      static_cast<const T*>(bo), static_cast<float*>(out),
      static_cast<float*>(scratch), steps, batch, hidden, adim, clip_value,
      p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define WIDE_ARGS p, noisy, ctx, noise, coeffs, wn, bn, wo, bo, out, \
    scratch, steps, batch, hidden, adim, clip_value, stream

template <typename T, int MODE, bool FAST>
cudaError_t launch_rows(const Plan& p, const void* noisy, const void* ctx,
                        const void* noise, const void* coeffs, const void* wn,
                        const void* bn, const void* wo, const void* bo,
                        void* out, void* scratch, int steps, int batch,
                        int hidden, int adim, float clip_value,
                        cudaStream_t stream) {
  switch (p.rows) {
    case 1: return launch_plan<T, MODE, FAST, 1>(WIDE_ARGS);
    case 2: return launch_plan<T, MODE, FAST, 2>(WIDE_ARGS);
    case 4: return launch_plan<T, MODE, FAST, 4>(WIDE_ARGS);
    default: return launch_plan<T, MODE, FAST, kMaxRows>(WIDE_ARGS);
  }
}

template <typename T, int MODE>
cudaError_t launch_fast(const Plan& p, const void* noisy, const void* ctx,
                        const void* noise, const void* coeffs, const void* wn,
                        const void* bn, const void* wo, const void* bo,
                        void* out, void* scratch, int steps, int batch,
                        int hidden, int adim, float clip_value,
                        cudaStream_t stream) {
  if (p.flags == kAll) return launch_rows<T, MODE, true>(WIDE_ARGS);
  return launch_rows<T, MODE, false>(WIDE_ARGS);
}

#undef WIDE_ARGS

template <typename T>
cudaError_t launch_mode(int mode, const Plan& p, const void* noisy,
                        const void* ctx, const void* noise,
                        const void* coeffs, const void* wn, const void* bn,
                        const void* wo, const void* bo, void* out,
                        void* scratch, int steps, int batch, int hidden,
                        int adim, float clip_value, cudaStream_t stream) {
  switch (mode) {
    case kDDPM:
      return launch_fast<T, kDDPM>(p, noisy, ctx, noise, coeffs, wn, bn, wo,
                                   bo, out, scratch, steps, batch, hidden,
                                   adim, clip_value, stream);
    case kDDIMRaw:
      return launch_fast<T, kDDIMRaw>(p, noisy, ctx, noise, coeffs, wn, bn,
                                      wo, bo, out, scratch, steps, batch,
                                      hidden, adim, clip_value, stream);
    case kDDIMRecompute:
      return launch_fast<T, kDDIMRecompute>(p, noisy, ctx, noise, coeffs, wn,
                                            bn, wo, bo, out, scratch, steps,
                                            batch, hidden, adim, clip_value,
                                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid(int steps, int batch, int hidden, int adim, int elem, int mode,
           int sms) {
  return steps >= 1 && batch >= 1 && hidden >= 1 && adim >= 1 && sms >= 1 &&
         (elem == 2 || elem == 4) && mode >= kDDPM && mode <= kDDIMRecompute;
}

}  // namespace

extern "C" {

// The launch's cut, into out[0 .. 10]: clusters, units, rows, groups,
// grid_y, g1, g2, flags, shared memory bytes, scratch floats (all blocks),
// blocks.  elem = compute dtype size; sms = the card's SM count.  Returns
// a cudaError_t (cudaErrorInvalidValue for a shape it cannot take).
int ddpm_sampler_wide_plan(int steps, int batch, int hidden, int adim,
                           int elem, int mode, int sms, long long* out) {
  if (!valid(steps, batch, hidden, adim, elem, mode, sms))
    return int(cudaErrorInvalidValue);
  const Plan p = make_plan(steps, batch, hidden, adim, elem, mode, sms);
  const long long blocks = (long long)p.clusters * p.grid_y;
  const long long v[11] = {p.clusters, p.units, p.rows, p.groups, p.grid_y,
                           1 << p.lg1, 1 << p.lg2, p.flags, p.smem,
                           blocks * p.scr_block, blocks};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  mode: 0 DDPM, 1 DDIM raw eps,
// 2 DDIM recomputed eps.  scratch: the floats ddpm_sampler_wide_plan
// reports (may be null when that is 0).  Returns a cudaError_t.
int ddpm_sampler_wide_launch(const void* noisy, const void* ctx,
                             const void* noise, const void* coeffs,
                             const void* wn, const void* bn, const void* wo,
                             const void* bo, void* out, void* scratch,
                             int steps, int batch, int hidden, int adim,
                             float clip_value, int dtype, int mode, int sms,
                             void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 ||
      !valid(steps, batch, hidden, adim, elem, mode, sms))
    return int(cudaErrorInvalidValue);
  const Plan p = make_plan(steps, batch, hidden, adim, elem, mode, sms);
  if (p.scr_block > 0 && scratch == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_mode<float>(mode, p, noisy, ctx, noise, coeffs, wn,
                                    bn, wo, bo, out, scratch, steps, batch,
                                    hidden, adim, clip_value, s));
    case 1:
      return int(launch_mode<__nv_bfloat16>(mode, p, noisy, ctx, noise,
                                            coeffs, wn, bn, wo, bo, out,
                                            scratch, steps, batch, hidden,
                                            adim, clip_value, s));
    default:
      return int(launch_mode<__half>(mode, p, noisy, ctx, noise, coeffs, wn,
                                     bn, wo, bo, out, scratch, steps, batch,
                                     hidden, adim, clip_value, s));
  }
}

const char* ddpm_sampler_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
"""


if __name__ == "__main__":
    sys.exit(main())
