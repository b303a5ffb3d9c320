"""Probe of the max-pool backward and the DDPM sampler on one H100.

    python3 pool_sampler_probe.py [pool] [pool_wide] [sampler]   (default: all)

Builds the shipped ``csrc/pool_bwd.cu`` and ``csrc/ddpm_sampler.cu``, the
bodies they replaced (the first versions of both, carried below as
source strings) and patched copies of the shipped sources, one
``nvcc`` each, all at once, and reads device times in turns (shipped,
variants, variants reversed, shipped) at the main paths' shapes:

  pool_bwd, bf16, octo_base training (N=1600, C=64, 23x23 -> 21x21):
    main           the shipped kernel on the layout the main path hands it
                   (x channels_last, g NCHW)
    nchw, nhwc     the shipped kernel with x and g both NCHW / both NHWC
    chunk16        16 bytes of channels a block (8 in bf16; 22 KB of shared
                   memory, nine blocks an SM) in place of 32
    chunk64        64 bytes a block (88 KB, two blocks an SM)
    first          the first pool kernel on NCHW x and g
    and, as the device time of every kernel of one call:
    first_wrapper  the first pool wrapper on the main path's layout: x and
                   g made contiguous, then its kernel
    wrapper        the shipped wrapper on the main path's layout
    library, library_nchw   torch's backward of F.max_pool2d on the main
                   path's layout / on NCHW
  pool_bwd at windows above 8 a side (its wide body), bf16, the same
  plane and layout, windows 9x9, 3x12 and 16x16:
    shipped        the separable body: row pass, column pass, gather
    slot_body      the body it replaced (carried below as SLOT_BODY): each
                   window read whole twice, each pixel testing every slot
    direct_rows    the row pass reading each row window whole, in place of
                   the prefix and suffix maxima
    direct         the search the body takes where its row arrays do not
                   fit beside the plane: no row pass, each window read
                   whole in the column pass
    rows_only, rows_cols   staging, the row pass (and the column pass) and
                   the store: the passes' times by difference (timed only)
    col_vanherk    the column pass by prefix and suffix maxima down each
                   output column, as the row pass, in place of reading each
                   window's row maxima
    library        torch's backward of F.max_pool2d, every kernel of a call
  ddpm_sampler, bf16 DDPM, octo_base serving (T=32, H=768, A=8), B=1, 8, 37:
    first          the first sampler kernel
    block128, block384, block768   blocks of that many threads (six,
                   two, one hidden unit a thread) in place of 256 (three)
    products       no staging: the contexts, coefficients and noise never
                   copied to shared memory (timed only)
    skeleton       no staging, no weights and no products: the step's
                   shuffles, its barrier and the update alone, the
                   sampler's latency floor (timed only)
    update_all     every thread sums all A partials and updates all A
                   values of the sample itself (no shuffles after the
                   barrier)
    noround        no rounding to bf16 anywhere (timed only)
    skeleton_nosync, skeleton_noreduce, skeleton_onewarp, skeleton_bare
                   the skeleton without the step's barrier / without the
                   transpose reduction / summing one warp's partials in
                   place of all / without all three (timed only: what
                   each part of the floor costs)

Every variant that computes the same function is held against the plain
version: the pool bit for bit, the sampler in units of eps * (1 + |plain|).
Writes every reading to ``chiprun_out/pool_sampler_probe.json`` and prints
it as the last line.  Needs the card and ``nvcc``; the shipped kernels are
held by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs

POOL_SHAPE = (cs.TRAIN_BATCH * 50, 64, 23, 23)
SAMPLER_BATCHES = (1, 8, 37)
POOL_WIDE_WINDOWS = cs.POOL_WIDE_WINDOWS

# The wide body's variants: (old, new) texts, or (start, end, new), the text
# from start up to end replaced.
_DIRECT_ROWS = """  // Row pass, direct: each output's row window read whole
  for (int item = tid; item < h * ow * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / how;
    const int u = XNHWC ? item / groups : item - p * how;
    const int i = u / ow, o = u - i * ow, c = p * L::N;
    uint32_t m = load<T, XNHWC>(xs, i * w + o, c, cb, hw);
    uint32_t col = splat(o);
    for (int k = o + 1; k < o + ww; ++k) {
      const uint32_t v = load<T, XNHWC>(xs, i * w + k, c, cb, hw);
      const uint32_t take = L::gt(v, m) | (~L::eq(v, v) & L::eq(m, m));
      m = L::max(m, v);
      col = (take & splat(k)) | (~take & col);
    }
    store<T, XNHWC>(rmax, u, c, cb, how, m);
    store<T, XNHWC>(rcol, u, c, cb, how, col);
  }
  __syncthreads();

"""
_COL_VANHERK = """  // Column pass, prefix and suffix maxima down each output column
  {
    const int nbc = (oh + wh - 1) / wh;
    T* cmax = xs;   // the suffix maxima, in x's place
    for (int item = tid; item < ow * nbc * groups; item += nthreads) {
      const int p = XNHWC ? item % groups : item / (ow * nbc);
      const int u = XNHWC ? item / groups : item - p * (ow * nbc);
      const int b = u / ow, oj = u - b * ow;
      const int o0 = b * wh, o1 = min(o0 + wh, oh), c = p * L::N;
      const auto finish = [&](int o, uint32_t m, uint32_t r) {
        uint32_t pix = 0u;
#pragma unroll
        for (int l = 0; l < L::N; ++l) {
          const int rl =
              static_cast<int>(L::N == 1 ? r : (r >> (16 * l)) & 0xffffu);
          const int cl = rc_l[lane_at<XNHWC>(rl * ow + oj, c + l, how, cb)];
          pix |= static_cast<uint32_t>(rl * w + cl) << (16 * l);
        }
        store<T, XNHWC>(wpix, o * ow + oj, c, cb, ohw, pix);
        const uint32_t nan = ~L::eq(m, m);
        if (nan)
          store<T, GNHWC>(gs, o * ow + oj, c, cb, ohw,
                          load<T, GNHWC>(gs, o * ow + oj, c, cb, ohw) & ~nan);
      };
      int k = o0 + wh - 1;
      uint32_t sm = load<T, XNHWC>(rmax, k * ow + oj, c, cb, how);
      uint32_t sr = splat(k);
      for (;;) {
        if (k < o1 && k > o0) {
          store<T, XNHWC>(cmax, k * ow + oj, c, cb, ohw, sm);
          store<T, XNHWC>(wpix, k * ow + oj, c, cb, ohw, sr);
        }
        if (--k < o0) break;
        const uint32_t v = load<T, XNHWC>(rmax, k * ow + oj, c, cb, how);
        const uint32_t take = L::ge(v, sm) | ~L::eq(v, v);
        sm = L::max(sm, v);
        sr = (take & splat(k)) | (~take & sr);
      }
      finish(o0, sm, sr);
      uint32_t pm = 0u, pr = 0u;
      for (int o = o0 + 1; o < o1; ++o) {
        const int kk = o + wh - 1;
        const uint32_t v = load<T, XNHWC>(rmax, kk * ow + oj, c, cb, how);
        const uint32_t take =
            o == o0 + 1 ? ~0u : L::gt(v, pm) | (~L::eq(v, v) & L::eq(pm, pm));
        pm = o == o0 + 1 ? v : L::max(pm, v);
        pr = (take & splat(kk)) | (~take & pr);
        const uint32_t sv = load<T, XNHWC>(cmax, o * ow + oj, c, cb, ohw);
        const uint32_t above = L::ge(sv, pm) | ~L::eq(sv, sv);
        const uint32_t r =
            (above & load<T, XNHWC>(wpix, o * ow + oj, c, cb, ohw)) |
            (~above & pr);
        finish(o, L::max(sv, pm), r);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < int(align16(size_t(hw) * at) / 16); i += nthreads)
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

"""
_NO_COLUMNS = ("item < ohw * groups; item", "item < 0; item")
_NO_GATHER = ("item < ow * cb; item", "item < 0; item")
POOL_WIDE_PATCHES = {
    "slot_body": [("// Any window (the body above takes up to kMaxWindow a "
                   "side): the same\n// staging, then a separable",
                   "// A block's chunk of channels (cb, a multiple of", None),
                  ("(rows ? 2 * size_t(h) * ow * at : 0)", "0"),
                  ("  if (wide) threads = kWideThreads;",
                   "  if (wide) threads = kMaxThreads;")],
    "direct_rows": [("  // Row pass.  Unit (row i, block b",
                     "  // Column pass:", _DIRECT_ROWS)],
    "direct": [("  const bool rows = smem_bytes(h, w, oh, ow, cb, sizeof(T), "
                "true) <= kSmemMax;", "  const bool rows = false;")],
    "rows_only": [_NO_COLUMNS, _NO_GATHER],
    "rows_cols": [_NO_GATHER],
    "col_vanherk": [("  // Column pass: the window's winning row, top to",
                     "  // Gather: thread (lane q, window column oj)",
                     _COL_VANHERK)],
}
POOL_WIDE_TIMED_ONLY = ("rows_only", "rows_cols")

# name -> [(text of the shipped source, its replacement)], each text found
# exactly once
POOL_PATCHES = {
    "chunk16": [("constexpr int kChunkBytes = 32;",
                 "constexpr int kChunkBytes = 16;")],
    "chunk64": [("constexpr int kChunkBytes = 32;",
                 "constexpr int kChunkBytes = 64;")],
}
_NO_STAGING = [
    ("""  stage_rows(ctx_s, hidden, ctx + size_t(b) * hidden, steps, hidden,
             size_t(batch) * hidden, tid, nthreads);
  stage_rows(coef_s, 0, coeffs, 1, steps * ncoef, 0, tid, nthreads);
  if (MODE == kDDPM) {""", "  if (false) {")]
_NO_WEIGHTS = [("    const bool on = u < units;", "    const bool on = false;")]
_NO_PRODUCTS = [("""        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < MA; ++a) acc = fmaf(xr[a], wn_r[u][a], acc);
        float h = rnd<T>(rnd<T>(acc) + bn_r[u]);
        h = fmaxf(rnd<T>(h + cur[u]), 0.f);
#pragma unroll
        for (int a = 0; a < MA; ++a) part[a] = fmaf(h, wo_r[u][a], part[a]);
""", """#pragma unroll
        for (int a = 0; a < MA; ++a) part[a] += xr[a];
""")]
_SKELETON = _NO_STAGING + _NO_WEIGHTS + _NO_PRODUCTS
_NO_SYNC = [("    __syncthreads();\n\n    float e = 0.f;", "    float e = 0.f;")]
_NO_REDUCE = [("    const float sum = transpose_reduce<MA>(part, lane);",
               "    const float sum = part[0];")]
_ONE_WARP = [("w < nwarps; ++w) e +=", "w < 1; ++w) e +=")]
_NO_ROUNDING = [("  return Cvt<T>::to_f(Cvt<T>::from_f(x));", "  return x;")]
# every thread sums all A partials and updates all A values of the sample
_UPDATE_ALL = [
    ("""  const int am = lane & (MA - 1);
  float x = am < adim ? noisy[size_t(b) * adim + am] : 0.f;
  const float bo_a = am < adim ? Cvt<T>::to_f(bo[am]) : 0.f;
""", """  float x[MA], bo_r[MA];
#pragma unroll
  for (int a = 0; a < MA; ++a) {
    x[a] = a < adim ? noisy[size_t(b) * adim + a] : 0.f;
    bo_r[a] = a < adim ? Cvt<T>::to_f(bo[a]) : 0.f;
  }
"""),
    ("""  spread<MA>(xr, rnd<T>(x));

  for (int t = 0;""", """#pragma unroll
  for (int a = 0; a < MA; ++a) xr[a] = rnd<T>(x[a]);

  for (int t = 0;"""),
    ("    const float nz = MODE == kDDPM ? noise_s[t * MA + am] : 0.f;",
     """    float nz[MA];
#pragma unroll
    for (int a = 0; a < MA; ++a)
      nz[a] = MODE == kDDPM ? noise_s[t * MA + a] : 0.f;"""),
    ("""    float e = 0.f;
    for (int w = 0; w < nwarps; ++w) e += buf[w * MA + am];
    float eps = rnd<T>(rnd<T>(e) + bo_a);
    float nx;
    if (MODE == kDDPM) {
      nx = c0 * (x - c1 * eps) + c2 * nz;
    } else {
      const float x0 = fminf(fmaxf(c0 * x - c1 * eps, -clip_value),
                             clip_value);
      if (MODE == kDDIMRecompute) eps = (c0 * x - x0) / c1;
      nx = c2 * x0 + c3 * eps;
    }
    x = fminf(fmaxf(nx, -clip_value), clip_value);
    spread<MA>(xr, rnd<T>(x));
""", """    float e[MA];
#pragma unroll
    for (int a = 0; a < MA; ++a) e[a] = 0.f;
    for (int w = 0; w < nwarps; ++w) {
#pragma unroll
      for (int a = 0; a < MA; a += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(buf + w * MA + a);
        e[a] += p4.x;
        e[a + 1] += p4.y;
        e[a + 2] += p4.z;
        e[a + 3] += p4.w;
      }
    }
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      float eps = rnd<T>(rnd<T>(e[a]) + bo_r[a]);
      float nx;
      if (MODE == kDDPM) {
        nx = c0 * (x[a] - c1 * eps) + c2 * nz[a];
      } else {
        const float x0 = fminf(fmaxf(c0 * x[a] - c1 * eps, -clip_value),
                               clip_value);
        if (MODE == kDDIMRecompute) eps = (c0 * x[a] - x0) / c1;
        nx = c2 * x0 + c3 * eps;
      }
      x[a] = fminf(fmaxf(nx, -clip_value), clip_value);
      xr[a] = rnd<T>(x[a]);
    }
"""),
    ("  if (tid < adim) out[size_t(b) * adim + tid] = x;",
     """  if (tid == 0) {
#pragma unroll
    for (int a = 0; a < MA; ++a)
      if (a < adim) out[size_t(b) * adim + a] = x[a];
  }""")]
SAMPLER_PATCHES = {
    **{f"block{n}": [("constexpr int kBlock = 256;",
                      f"constexpr int kBlock = {n};")]
       for n in (128, 384, 768)},
    "products": _NO_STAGING,
    "skeleton": _SKELETON,
    "skeleton_nosync": _SKELETON + _NO_SYNC,
    "skeleton_noreduce": _SKELETON + _NO_REDUCE,
    "skeleton_onewarp": _SKELETON + _ONE_WARP,
    "skeleton_bare": _SKELETON + _NO_SYNC + _NO_REDUCE + _ONE_WARP,
    "noround": _NO_ROUNDING,
    "update_all": _UPDATE_ALL,
}
SAMPLER_TIMED_ONLY = ("products", "skeleton", "skeleton_nosync",
                      "skeleton_noreduce", "skeleton_onewarp",
                      "skeleton_bare", "noround")

# the first csrc/pool_bwd.cu (eight NCHW planes a block, staged in float32
# one 2-byte element a thread at a time), its source note left out
FIRST_POOL = r"""#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 8;
constexpr int kMaxPlanesPerBlock = 8;
constexpr size_t kSmemBudget = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_f(float x) {
    return __float2half_rn(x);
  }
};

size_t plane_bytes(int h, int w, int oh, int ow) {
  // x and g planes as float32, the winning slot of each window as int8
  return sizeof(float) * (static_cast<size_t>(h) * w +
                          static_cast<size_t>(oh) * ow) +
         static_cast<size_t>(oh) * ow;
}

// n / d for 0 <= n < 2^20 through a float reciprocal: (n + 0.5) / d lies
// at least 0.5 / d from an integer, far beyond the float error of the
// product at these sizes.  The integer division it replaces costs some
// twenty instructions, and the kernel does four per element.
__device__ __forceinline__ int div_small(int n, float inv_d) {
  return __float2int_rd((static_cast<float>(n) + 0.5f) * inv_d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, long planes, int h, int w, int wh,
                    int ww, int per_block) {
  extern __shared__ float smem[];
  const int oh = h - wh + 1, ow = w - ww + 1;
  const int hw = h * w, ohw = oh * ow;
  const float inv_hw = 1.f / hw, inv_ohw = 1.f / ohw, inv_w = 1.f / w,
              inv_ow = 1.f / ow;
  const long plane0 = static_cast<long>(blockIdx.x) * per_block;
  const int np = static_cast<int>(
      min(static_cast<long>(per_block), planes - plane0));
  float* sx = smem;
  float* sg = sx + static_cast<size_t>(per_block) * hw;
  int8_t* win = reinterpret_cast<int8_t*>(sg + static_cast<size_t>(per_block) *
                                                   ohw);
  const T* xb = x + plane0 * hw;
  const T* gb = g + plane0 * ohw;

  for (int i = threadIdx.x; i < np * hw; i += kThreads)
    sx[i] = Cvt<T>::to_f(xb[i]);
  for (int i = threadIdx.x; i < np * ohw; i += kThreads)
    sg[i] = Cvt<T>::to_f(gb[i]);
  __syncthreads();

  // the winning slot of every window (-1: a NaN in the window)
  for (int i = threadIdx.x; i < np * ohw; i += kThreads) {
    const int p = div_small(i, inv_ohw), o = i - p * ohw;
    const int oi = div_small(o, inv_ow), oj = o - oi * ow;
    const float* xp = sx + p * hw + oi * w + oj;
    float m = -INFINITY;
    bool nan = false;
    for (int di = 0; di < wh; ++di)
      for (int dj = 0; dj < ww; ++dj) {
        const float val = xp[di * w + dj];
        nan |= val != val;
        m = fmaxf(m, val);
      }
    int slot = -1;
    for (int di = 0; di < wh && slot < 0 && !nan; ++di)
      for (int dj = 0; dj < ww; ++dj)
        if (xp[di * w + dj] == m) {
          slot = di * ww + dj;
          break;
        }
    win[i] = static_cast<int8_t>(slot);
  }
  __syncthreads();

  // every input element gathers the windows it won, slot by slot
  T* db = dx + plane0 * hw;
  for (int i = threadIdx.x; i < np * hw; i += kThreads) {
    const int p = div_small(i, inv_hw), e = i - p * hw;
    const int ii = div_small(e, inv_w), jj = e - ii * w;
    const float* gp = sg + p * ohw;
    const int8_t* wp = win + p * ohw;
    T acc = Cvt<T>::from_f(0.f);
    for (int di = 0; di < wh; ++di) {
      const int oi = ii - di;
      if (oi < 0 || oi >= oh) continue;
      for (int dj = 0; dj < ww; ++dj) {
        const int oj = jj - dj;
        if (oj < 0 || oj >= ow) continue;
        if (wp[oi * ow + oj] == di * ww + dj)
          acc = Cvt<T>::from_f(Cvt<T>::to_f(acc) + gp[oi * ow + oj]);
      }
    }
    db[i] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, long planes, int h, int w,
           int wh, int ww, cudaStream_t stream) {
  const int oh = h - wh + 1, ow = w - ww + 1;
  const size_t per_plane = plane_bytes(h, w, oh, ow);
  int per_block = static_cast<int>(kSmemBudget / per_plane);
  if (per_block > kMaxPlanesPerBlock) per_block = kMaxPlanesPerBlock;
  if (per_block < 1) per_block = 1;
  const size_t smem = per_plane * per_block;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemBudget) {
    cudaError_t err = cudaFuncSetAttribute(
        pool_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = (planes + per_block - 1) / per_block;
  if (blocks > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  pool_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(static_cast<const T*>(x),
                                 static_cast<const T*>(g), static_cast<T*>(dx),
                                 planes, h, w, wh, ww, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, dx (planes, h, w) and g (planes, h - wh + 1, w - ww + 1), contiguous
// in the dtype (0 float32, 1 bfloat16, 2 float16).  Returns the
// cudaError_t of the launch (0 on success); never synchronises.
int pool_bwd_launch(const void* x, const void* g, void* dx, int planes, int h,
                    int w, int wh, int ww, int dtype, void* stream) {
  if (planes <= 0 || wh < 1 || ww < 1 || wh > kMaxWindow ||
      ww > kMaxWindow || wh > h || ww > w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, g, dx, planes, h, w, wh, ww, s);
    case 1: return launch<__nv_bfloat16>(x, g, dx, planes, h, w, wh, ww, s);
    case 2: return launch<__half>(x, g, dx, planes, h, w, wh, ww, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* pool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
"""

# the first csrc/ddpm_sampler.cu (weights in shared memory, two barriers a
# step), its source note left out
FIRST_SAMPLER = r"""#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxA = 16;

enum Mode { kDDPM = 0, kDDIMRaw = 1, kDDIMRecompute = 2 };

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

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// shared memory: Wn (H*A), Wo (A*H), bn (H), ctx (T*H) in T; then floats
__host__ __device__ __forceinline__ size_t smem_bytes(int steps, int hidden,
                                                      int adim, int elem) {
  size_t n = align16(size_t(2) * hidden * adim * elem);
  n += align16(size_t(hidden) * elem);
  n += align16(size_t(steps) * hidden * elem);
  n += sizeof(float) * (kWarps * kMaxA + 2 * kMaxA);
  return n;
}

// Copy `rows` rows of `row_elems` elements from global memory (rows
// `src_stride` elements apart) to consecutive rows in shared memory.  Rows
// of whole 16-byte chunks go through cp.async, all in flight at once;
// otherwise element by element.  The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           int row_elems, size_t src_stride,
                                           int tid) {
  const size_t row_bytes = size_t(row_elems) * sizeof(T);
  const bool vec = row_bytes % 16 == 0 &&
                   (src_stride * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int per_row = int(row_bytes / 16);
    for (int c = tid; c < rows * per_row; c += kThreads) {
      const int r = c / per_row;
      const int k = c - r * per_row;
      __pipeline_memcpy_async(
          reinterpret_cast<char*>(dst) + r * row_bytes + size_t(k) * 16,
          reinterpret_cast<const char*>(src + r * src_stride) +
              size_t(k) * 16,
          16);
    }
  } else {
    for (int i = tid; i < rows * row_elems; i += kThreads) {
      const int r = i / row_elems;
      dst[i] = src[r * src_stride + (i - r * row_elems)];
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
ddpm_sampler_kernel(const float* __restrict__ noisy,   // (B, A)
                    const T* __restrict__ ctx,         // (T, B, H)
                    const float* __restrict__ noise,   // (T, B, A), DDPM only
                    const float* __restrict__ coeffs,  // (T, 3) or (T, 4)
                    const T* __restrict__ wn,          // (H, A)
                    const T* __restrict__ bn,          // (H)
                    const T* __restrict__ wo,          // (A, H)
                    const T* __restrict__ bo,          // (A)
                    float* __restrict__ out,           // (B, A)
                    int steps, int batch, int hidden, int adim,
                    float clip_value) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ha = hidden * adim;
  T* wn_s = reinterpret_cast<T*>(smem);
  T* wo_s = wn_s + ha;
  unsigned char* p = smem + align16(size_t(2) * ha * sizeof(T));
  T* bn_s = reinterpret_cast<T*>(p);
  p += align16(size_t(hidden) * sizeof(T));
  T* ctx_s = reinterpret_cast<T*>(p);
  p += align16(size_t(steps) * hidden * sizeof(T));
  float* part_s = reinterpret_cast<float*>(p);  // [kWarps][kMaxA]
  float* x_s = part_s + kWarps * kMaxA;          // [kMaxA]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ncoef = MODE == kDDPM ? 3 : 4;

  // everything the loop reads from device memory, in flight at once
  stage_rows(wn_s, wn, 1, ha, 0, tid);
  stage_rows(wo_s, wo, 1, ha, 0, tid);
  stage_rows(bn_s, bn, 1, hidden, 0, tid);
  stage_rows(ctx_s, ctx + size_t(b) * hidden, steps, hidden,
             size_t(batch) * hidden, tid);
  __pipeline_commit();
  if (tid < adim) x_s[tid] = noisy[size_t(b) * adim + tid];
  const float bo_f = tid < adim ? Cvt<T>::to_f(bo[tid]) : 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    // the state update's inputs do not depend on this step's product:
    // issue their loads first so they overlap with it
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    float nz = 0.f;
    if (tid < adim) {
      for (int k = 0; k < ncoef; ++k) c[k] = coeffs[t * ncoef + k];
      if (MODE == kDDPM) nz = noise[(size_t(t) * batch + b) * adim + tid];
    }

    float xr[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) xr[a] = a < adim ? rnd<T>(x_s[a]) : 0.f;

    float part[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) part[a] = 0.f;

    const T* ctx_t = ctx_s + size_t(t) * hidden;
    for (int j = tid; j < hidden; j += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < kMaxA; ++a)
        if (a < adim) acc = fmaf(xr[a], Cvt<T>::to_f(wn_s[j * adim + a]), acc);
      float h = rnd<T>(rnd<T>(acc) + Cvt<T>::to_f(bn_s[j]));
      h = rnd<T>(h + Cvt<T>::to_f(ctx_t[j]));
      h = fmaxf(h, 0.f);
#pragma unroll
      for (int a = 0; a < kMaxA; ++a)
        if (a < adim)
          part[a] = fmaf(h, Cvt<T>::to_f(wo_s[a * hidden + j]), part[a]);
    }

#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < adim) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[a] += __shfl_xor_sync(0xffffffffu, part[a], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < kMaxA; ++a)
        if (a < adim) part_s[warp * kMaxA + a] = part[a];
    }
    __syncthreads();

    if (tid < adim) {
      float e = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) e += part_s[w * kMaxA + tid];
      float eps = rnd<T>(rnd<T>(e) + bo_f);
      const float x = x_s[tid];
      float nx;
      if (MODE == kDDPM) {
        nx = c[0] * (x - c[1] * eps) + c[2] * nz;
      } else {
        float x0 = fminf(fmaxf(c[0] * x - c[1] * eps, -clip_value),
                         clip_value);
        if (MODE == kDDIMRecompute) eps = (c[0] * x - x0) / c[1];
        nx = c[2] * x0 + c[3] * eps;
      }
      x_s[tid] = fminf(fmaxf(nx, -clip_value), clip_value);
    }
    __syncthreads();
  }

  if (tid < adim) out[size_t(b) * adim + tid] = x_s[tid];
}

template <typename T, int MODE>
cudaError_t launch_typed(const void* noisy, const void* ctx, const void* noise,
                         const void* coeffs, const void* wn, const void* bn,
                         const void* wo, const void* bo, void* out, int steps,
                         int batch, int hidden, int adim, float clip_value,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(steps, hidden, adim, sizeof(T));
  auto kernel = ddpm_sampler_kernel<T, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(
      static_cast<const float*>(noisy), static_cast<const T*>(ctx),
      static_cast<const float*>(noise), static_cast<const float*>(coeffs),
      static_cast<const T*>(wn), static_cast<const T*>(bn),
      static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<float*>(out), steps, batch, hidden, adim, clip_value);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* noisy, const void* ctx,
                        const void* noise, const void* coeffs, const void* wn,
                        const void* bn, const void* wo, const void* bo,
                        void* out, int steps, int batch, int hidden, int adim,
                        float clip_value, cudaStream_t stream) {
  switch (mode) {
    case kDDPM:
      return launch_typed<T, kDDPM>(noisy, ctx, noise, coeffs, wn, bn, wo, bo,
                                    out, steps, batch, hidden, adim,
                                    clip_value, stream);
    case kDDIMRaw:
      return launch_typed<T, kDDIMRaw>(noisy, ctx, noise, coeffs, wn, bn, wo,
                                       bo, out, steps, batch, hidden, adim,
                                       clip_value, stream);
    case kDDIMRecompute:
      return launch_typed<T, kDDIMRecompute>(noisy, ctx, noise, coeffs, wn, bn,
                                             wo, bo, out, steps, batch, hidden,
                                             adim, clip_value, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block needs; elem = compute dtype size
size_t ddpm_sampler_smem_bytes(int steps, int hidden, int adim, int elem) {
  return smem_bytes(steps, hidden, adim, elem);
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  mode: 0 DDPM, 1 DDIM raw eps,
// 2 DDIM recomputed eps.  Returns a cudaError_t.
int ddpm_sampler_launch(const void* noisy, const void* ctx, const void* noise,
                        const void* coeffs, const void* wn, const void* bn,
                        const void* wo, const void* bo, void* out, int steps,
                        int batch, int hidden, int adim, float clip_value,
                        int dtype, int mode, void* stream) {
  if (adim < 1 || adim > kMaxA || steps < 1 || batch < 1 || hidden < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_mode<float>(mode, noisy, ctx, noise, coeffs, wn, bn,
                                    wo, bo, out, steps, batch, hidden, adim,
                                    clip_value, s));
    case 1:
      return int(launch_mode<__nv_bfloat16>(mode, noisy, ctx, noise, coeffs,
                                            wn, bn, wo, bo, out, steps, batch,
                                            hidden, adim, clip_value, s));
    case 2:
      return int(launch_mode<__half>(mode, noisy, ctx, noise, coeffs, wn, bn,
                                     wo, bo, out, steps, batch, hidden, adim,
                                     clip_value, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* ddpm_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
"""


def patched(src, patches):
    """``src`` with each (old, new) text replaced, or with each (start, end,
    new) the text from start up to end (new None: SLOT_BODY); every old,
    start and end found exactly once."""
    for patch in patches:
        for text in patch[:-1]:
            if src.count(text) != 1:
                raise SystemExit(f"patch text found {src.count(text)} "
                                 f"times: {text[:60]!r}")
        if len(patch) == 2:
            src = src.replace(*patch)
        else:
            start, end, new = patch
            i, j = src.index(start), src.index(end)
            src = src[:i] + (SLOT_BODY if new is None else new) + src[j:]
    return src


def build(_build, sources, kind):
    """name -> loaded library of every source text of ``sources``, one nvcc
    each, in parallel; logs each one's registers and spills."""
    root = _build.BUILD_DIR / "probe"
    root.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, text in sources.items():
        cu = root / f"{kind}_{name}.cu"
        cu.write_text(text)
        so = root / f"lib{kind}_{name}.so"
        running[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {kind} {name} copy:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
        entries = cs.ptxas_entries(out, (kind.split("_")[0],))
        cs.log(f"  {kind} {name}: " + ", ".join(
            f"{e} {regs} registers, {spill} bytes spill stores"
            for e, (regs, spill) in sorted(entries.items())
            if "bfloat16" in e and ("3, 3" in e or kind != "pool_bwd")))
    return libs


def checked(rc, what):
    if rc != 0:
        raise SystemExit(f"{what} launch failed: {rc}")


def pool_call(lib, x, g, x_nhwc, g_nhwc, dx, first=False, window=(3, 3)):
    """One launch of a pool library on x, g into dx (no wrapper)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    n, c, h, w = x.shape
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if first:
        lib.pool_bwd_launch.argtypes = [vp] * 3 + [ci] * 6 + [vp]
        return lambda: checked(lib.pool_bwd_launch(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), n * c, h, w, 3, 3, 1,
            stream()), "pool")
    lib.pool_bwd_launch.argtypes = [vp] * 3 + [ci] * 9 + [vp]
    return lambda: checked(lib.pool_bwd_launch(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, c, h, w, *window,
        int(x_nhwc), int(g_nhwc), 1, stream()), "pool")


def pool_cases(pool, libs):
    """name -> (kind, call, dx or None): 'kernel' timed by the pool
    kernel's records, 'total' by every kernel of a call."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = (torch.randn(*POOL_SHAPE, generator=gen, device="cuda") * 2
            ).round() / 2
    base[0, 0, 5, 5] = float("nan")
    n, c, h, w = POOL_SHAPE
    g = torch.randn(n, c, h - 2, w - 2, generator=gen,
                    device="cuda").to(torch.bfloat16)
    x = base.to(torch.bfloat16)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    g_cl = g.contiguous(memory_format=torch.channels_last)
    out = lambda t: torch.empty_like(t)
    cases = {}
    for name, lib in (("main", libs["shipped"]), ("chunk16", libs["chunk16"]),
                      ("chunk64", libs["chunk64"])):
        dx = out(x_cl)
        cases[name] = ("kernel", pool_call(lib, x_cl, g, True, False, dx), dx)
    dx = out(x)
    cases["nchw"] = ("kernel", pool_call(libs["shipped"], x, g, False, False,
                                         dx), dx)
    dx = out(x_cl)
    cases["nhwc"] = ("kernel", pool_call(libs["shipped"], x_cl, g_cl, True,
                                         True, dx), dx)
    dx = out(x)
    cases["first"] = ("kernel", pool_call(libs["first"], x, g, False, False,
                                          dx, first=True), dx)
    dx2 = out(x)

    def first_wrapper():
        xc, gc = x_cl.contiguous(), g.contiguous()
        pool_call(libs["first"], xc, gc, False, False, dx2, first=True)()

    cases["first_wrapper"] = ("total", first_wrapper, None)
    cases["wrapper"] = ("total", lambda: pool.pool_bwd(x_cl, g, (3, 3)), None)
    for name, xin in (("library", x_cl), ("library_nchw", x)):
        xg = xin.detach().requires_grad_(True)
        y = F.max_pool2d(xg, 3, 1)
        cases[name] = ("total", lambda y=y, xg=xg: torch.autograd.grad(
            y, xg, g, retain_graph=True), None)
    return cases, pool.pool_bwd_reference(x, g, (3, 3))


def sampler_call(lib, x, coeffs, out):
    vp = ctypes.c_void_p
    lib.ddpm_sampler_launch.argtypes = [vp] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
    t, b, h = x["contexts"].shape
    a = x["noisy"].shape[1]
    return lambda: checked(lib.ddpm_sampler_launch(
        x["noisy"].data_ptr(), x["contexts"].data_ptr(),
        x["noise"].data_ptr(), coeffs.data_ptr(), x["wn"].data_ptr(),
        x["bn"].data_ptr(), x["wo"].data_ptr(), x["bo"].data_ptr(),
        out.data_ptr(), t, b, h, a, 5.0, 1, 0,
        torch.cuda.current_stream().cuda_stream), "sampler")


def in_turns(cases, kernel):
    """name -> mean device us over two readings in turns."""
    order = list(cases)
    times = {}
    for name in order + order[::-1]:
        kind, call = cases[name][:2]
        ms = (cs.device_ms(call, kernel) if kind == "kernel"
              else cs.device_total_ms(call)[0])
        times.setdefault(name, []).append(ms)
    return {n: sum(t) / len(t) * 1e3 for n, t in times.items()}


def main():
    if not torch.cuda.is_available():
        cs.log("no CUDA device: pool_sampler_probe.py runs on the card only")
        return 2
    from multi_modal_transformers_tokenmerge_torch import _build
    parts = set(sys.argv[1:]) or {"pool", "pool_wide", "sampler"}
    if parts - {"pool", "pool_wide", "sampler"}:
        raise SystemExit(f"unknown parts {sorted(parts)}: pool, pool_wide, "
                         f"sampler")
    card = cs.card_line()
    cs.log(card)
    cs.profile_session(lambda: None)
    t0 = time.perf_counter()
    readings = {}
    if "pool" in parts:
        pool_src = _build.sources()["pool_bwd"].read_text()
        pool_libs = build(_build, {
            "shipped": pool_src, "first": FIRST_POOL,
            **{k: patched(pool_src, p) for k, p in POOL_PATCHES.items()}},
            "pool_bwd")
        readings.update(time_pool(pool_libs))
    if "pool_wide" in parts:
        pool_src = _build.sources()["pool_bwd"].read_text()
        wide_libs = build(_build, {"shipped": pool_src, **{
            k: patched(pool_src, p) for k, p in POOL_WIDE_PATCHES.items()}},
            "pool_bwd_wide")
        readings.update(time_pool_wide(wide_libs))
    if "sampler" in parts:
        samp_src = _build.sources()["ddpm_sampler"].read_text()
        samp_libs = build(_build, {
            "shipped": samp_src, "first": FIRST_SAMPLER,
            **{k: patched(samp_src, p) for k, p in SAMPLER_PATCHES.items()}},
            "ddpm_sampler")
        readings.update(time_sampler(samp_libs))
    cs.log(f"built and timed in {time.perf_counter() - t0:.1f} s")

    result = {"card": card, "readings_us": readings,
              "guard_records_lost": cs._GUARD["lost"],
              "kernel_sessions_run_again": cs._GUARD["short"]}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "pool_sampler_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def time_pool(pool_libs):
    from multi_modal_transformers_tokenmerge_torch.ops import pool
    cases, want = pool_cases(pool, pool_libs)
    row = in_turns(cases, "pool_bwd_kernel")
    for name, (kind, call, dx) in cases.items():
        if dx is not None:
            call()
            torch.cuda.synchronize()
            row[f"{name}_bit_for_bit"] = bool(torch.equal(dx, want))
    cs.log(f"  pool_bwd us: {row}")
    return {"pool_bwd bf16 N=1600 C=64 23x23": row}


def time_pool_wide(libs):
    """The wide body's variants at each window of POOL_WIDE_WINDOWS on the
    main path's layout, in turns, each that computes the backward held bit
    for bit against the plain version."""
    import torch.nn.functional as F
    from multi_modal_transformers_tokenmerge_torch.ops import pool
    gen = torch.Generator(device="cuda").manual_seed(5)
    base = (torch.randn(*POOL_SHAPE, generator=gen, device="cuda") * 2
            ).round() / 2
    base[0, 0, 11, 11] = float("nan")
    x = base.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    n, c, h, w = POOL_SHAPE
    readings = {}
    for window in POOL_WIDE_WINDOWS:
        oh, ow = h - window[0] + 1, w - window[1] + 1
        g = torch.randn(n, c, oh, ow, generator=gen,
                        device="cuda").to(torch.bfloat16)
        cases = {}
        for name, lib in libs.items():
            dx = torch.empty_like(x)
            cases[name] = ("kernel", pool_call(lib, x, g, True, False, dx,
                                               window=window), dx)
        xg = x.detach().requires_grad_(True)
        y = F.max_pool2d(xg, window, 1)
        cases["library"] = ("total", lambda y=y, xg=xg, g=g: torch.autograd
                            .grad(y, xg, g, retain_graph=True), None)
        row = in_turns(cases, "pool_bwd_wide_kernel")
        want = pool.pool_bwd_reference(x, g, window)
        for name, (kind, call, dx) in cases.items():
            if dx is not None and name not in POOL_WIDE_TIMED_ONLY:
                call()
                torch.cuda.synchronize()
                row[f"{name}_bit_for_bit"] = bool(torch.equal(dx, want))
        label = f"pool_bwd_wide bf16 N=1600 C=64 23x23 window {window}"
        cs.log(f"  {label} us: {row}")
        readings[label] = row
    return readings


def time_sampler(samp_libs):
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        DiffusionHeadConfig)
    from multi_modal_transformers_tokenmerge_torch.heads.diffusion import (
        DiffusionActionHead)
    from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
        ddpm_sample_reference)
    readings = {}
    head = DiffusionActionHead(DiffusionHeadConfig(), 768, device="cuda")
    coeffs = head.schedule(None)[1].float().contiguous()
    for batch in SAMPLER_BATCHES:
        x = cs.sampler_inputs(head, batch, 32, torch.bfloat16,
                              seed=100 + batch)
        x.update({k: x[k].to(torch.bfloat16).contiguous()
                  for k in ("wn", "bn", "wo", "bo")})
        want = ddpm_sample_reference(
            x["noisy"], x["contexts"], x["noise"], coeffs, x["wn"], x["bn"],
            x["wo"], x["bo"], clip_value=5.0)
        outs = {n: torch.empty_like(x["noisy"]) for n in samp_libs}
        cases = {n: ("kernel", sampler_call(lib, x, coeffs, outs[n]))
                 for n, lib in samp_libs.items()}
        cases = {"shipped": cases.pop("shipped"), **cases}
        row = in_turns(cases, "ddpm_sampler_kernel")
        eps = torch.finfo(torch.bfloat16).eps
        for name in samp_libs:
            if name in SAMPLER_TIMED_ONLY:
                continue
            cases[name][1]()
            torch.cuda.synchronize()
            got = outs[name]
            row[f"{name}_eps_units"] = ((got - want).abs() / (
                eps * (1 + want.abs()))).max().item()
        readings[f"ddpm_sampler bf16 DDPM T=32 H=768 A=8 B={batch}"] = row
        cs.log(f"  ddpm_sampler B={batch} us: {row}")
    return readings


# The wide body the separable one replaced (csrc/pool_bwd.cu's
# pool_bwd_wide_kernel and its slot codes as they were).
SLOT_BODY = """// The winning slot of a window as an integer in each lane (16 bits a lane
// in 16-bit dtypes, 0xffff for none; 32 in float32, ~0 for none), and the
// lane mask of two codes' equal lanes.
template <typename T>
struct Slots {
  static __device__ __forceinline__ uint32_t splat(int k) {
    return (static_cast<uint32_t>(k) & 0xffffu) * 0x10001u;
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return __vcmpeq2(a, b);
  }
};
template <>
struct Slots<float> {
  static __device__ __forceinline__ uint32_t splat(int k) {
    return static_cast<uint32_t>(k);
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return a == b ? 0xffffffffu : 0u;
  }
};

// Any window (the body above takes up to kMaxWindow a side): the same
// staging, winners and gather, each window read from shared memory.
template <typename T, bool XNHWC, bool GNHWC>
__global__ void __launch_bounds__(kMaxThreads)
    pool_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, int chans, int h, int w, int wh,
                         int ww, int cb) {
  using L = Lanes<T>;
  using K = Slots<T>;
  const int oh = h - wh + 1, ow = w - ww + 1;
  const int hw = h * w, ohw = oh * ow;
  const int chunks = (chans + cb - 1) / cb;
  const int img = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - img * chunks) * cb;
  const int cv = min(cb, chans - c0);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // x, then dx
  T* gs = reinterpret_cast<T*>(smem + align16(size_t(hw) * cb * sizeof(T)));
  T* cs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(gs) +
                               align16(size_t(ohw) * cb * sizeof(T)));
  const size_t xoff = XNHWC ? size_t(img) * hw * chans + c0
                            : (size_t(img) * chans + c0) * hw;
  const size_t goff = GNHWC ? size_t(img) * ohw * chans + c0
                            : (size_t(img) * chans + c0) * ohw;
  if constexpr (XNHWC)
    copy_rows<T, true>(xs, x + xoff, nullptr, hw, cv, chans, cb, tid,
                       nthreads);
  else
    copy_rows<T, true>(xs, x + xoff, nullptr, 1, cv * hw, 0, 0, tid,
                       nthreads);
  if constexpr (GNHWC)
    copy_rows<T, true>(gs, g + goff, nullptr, ohw, cv, chans, cb, tid,
                       nthreads);
  else
    copy_rows<T, true>(gs, g + goff, nullptr, 1, cv * ohw, 0, 0, tid,
                       nthreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int groups = cb / L::N;
  const uint32_t none = K::splat(-1);
  // Winners: the window's max (max.NaN: a NaN window matches nothing), then
  // its first slot in raster order holding it.
  for (int item = tid; item < ohw * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / ohw;
    const int o = XNHWC ? item / groups : item % ohw;
    const int oi = o / ow, oj = o - oi * ow, c = p * L::N;
    uint32_t wm = load<T, XNHWC>(xs, oi * w + oj, c, cb, hw);
    for (int di = 0; di < wh; ++di)
      for (int dj = 0; dj < ww; ++dj)
        wm = L::max(wm, load<T, XNHWC>(xs, (oi + di) * w + oj + dj, c, cb,
                                       hw));
    uint32_t code = none;
    for (int slot = wh * ww - 1; slot >= 0; --slot) {
      const int di = slot / ww, dj = slot - di * ww;
      const uint32_t e =
          L::eq(load<T, XNHWC>(xs, (oi + di) * w + oj + dj, c, cb, hw), wm);
      code = (e & K::splat(slot)) | (~e & code);
    }
    store<T, XNHWC>(cs, o, c, cb, ohw, code);
  }
  __syncthreads();

  // Gather: dx(i, j) adds g of every window it won, in slot order.
  for (int item = tid; item < hw * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / hw;
    const int e = XNHWC ? item / groups : item % hw;
    const int i = e / w, j = e - i * w, c = p * L::N;
    uint32_t acc = 0u;
    for (int di = 0; di < wh; ++di) {
      const int oi = i - di;
      if (oi < 0 || oi >= oh) continue;
      for (int dj = 0; dj < ww; ++dj) {
        const int oj = j - dj;
        if (oj < 0 || oj >= ow) continue;
        const uint32_t won = K::eq(load<T, XNHWC>(cs, oi * ow + oj, c, cb, ohw),
                                   K::splat(di * ww + dj));
        acc = L::add(acc, load<T, GNHWC>(gs, oi * ow + oj, c, cb, ohw) & won);
      }
    }
    // every thread has read its x values in the winner pass: dx may take
    // x's place
    store<T, XNHWC>(xs, e, c, cb, hw, acc);
  }
  __syncthreads();

  if constexpr (XNHWC)
    copy_rows<T, false>(xs, nullptr, dx + xoff, hw, cv, chans, cb, tid,
                        nthreads);
  else
    copy_rows<T, false>(xs, nullptr, dx + xoff, 1, cv * hw, 0, 0, tid,
                        nthreads);
}

"""


if __name__ == "__main__":
    sys.exit(main())
