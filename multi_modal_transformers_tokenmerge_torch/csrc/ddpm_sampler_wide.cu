// Fused DDPM / DDIM reverse sampler for Hopper (sm_90a): the wide kernel,
// for every shape the register kernel (ddpm_sampler.cu) does not take.
//
// Replaces the Pallas kernel ops/ddpm_sampler.py:_sampler_kernel of the JAX
// package at any action dim A, hidden width H, step count T and batch B.
// It computes what ddpm_sampler.cu computes, with the same rounding points:
//
//   h   = relu(cd(cd(cd(x . Wn^T) + bn) + ctx[t]))      (cd: round to the
//   eps = f32(cd(cd(h . Wo^T) + bo))                      compute dtype)
//   then the float32 DDPM / DDIM update of the mode and the clip.
//
// What bounds it on this card: latency, as for the register kernel.  At
// octo_base_chunk28 (T=100, H=3072, A=28, bf16) one batch row moves about
// 0.96 MB (its contexts and the weights) and does 34 MFLOP: under a
// microsecond of HBM time.  The T steps depend on each other; each is two
// products, a reduction across the hidden units and an update that the next
// step needs.  What the register design cannot hold there: Wn and Wo take
// 2 A H elements (344 KB in bf16 at that shape, 4.3 MB at A=1400, H=768),
// more than one block's registers or its 227 KB of shared memory, and the
// contexts of all T steps (1.2 MB a row in float32 at T=100) more still.
//
// What the design does about it:
// - A thread block cluster of C <= 8 blocks splits the hidden units: block
//   c owns units [c U, (c + 1) U), U a multiple of 8, and keeps its slice
//   of Wn and Wo (2 A U elements) and of bn in shared memory for the whole
//   loop.  Each step it computes h for its units and the partial eps sums
//   of all A actions over them, and stores them by st.async into slot c of
//   every block's shared memory, the bytes completing on that block's
//   mbarrier; each block waits on its own barrier until its C slots have
//   landed (no cluster barrier on the step's path), adds them in rank
//   order and updates the whole sample itself, so the next step needs no
//   second exchange.  The slots and barriers are double-buffered by the
//   step's parity: a block sends step t + 1's sums only once it holds all
//   of step t's, and each of those was sent after its sender had read
//   step t - 1's buffer, the one step t + 1 reuses.  C is set by H, A and
//   the dtype alone.  One cluster barrier after the barriers are set up,
//   one as a block ends a row group.
// - A block takes ROWS batch rows (1, 2, 4 or 8, a template argument, so
//   the products' inner loops carry no per-row test), so that one read of
//   its weights serves them all; ROWS is set by the batch and the card's
//   SM count.  Each row's sums run in an order set by (H, A, dtype) alone,
//   so a row's result does not depend on the batch or its blocking: the
//   order of a 256-thread split (kOrderThreads), as in the body before
//   this one, whose results this kernel gives bit for bit.
// - 384 threads a block, so that the first product's 384 units a block at
//   octo_base_chunk28 (H=3072 over 8 blocks) take one pass, not two.
// - Contexts and noise stream through a ring of 4 shared memory stages, 3
//   steps ahead of the loop, so that shared memory does not grow with T.
//   Where every row a stage copies starts and ends on 16 bytes (H elem and,
//   in DDPM, 4 A multiples of 16), one thread copies a stage by
//   cp.async.bulk, its bytes completing on the stage's own barrier, which
//   the step waits on; elsewhere every thread issues 16- or 4-byte
//   cp.async copies (at octo_base_chunk28 those add half a microsecond to
//   a 2.2 us step: sampler_wide_probe.py, no_bulk).  A step's coefficients
//   are loaded into registers as it starts and used after both products.
// - Both products split their sums over g lanes of a warp (g a power of
//   two, g = 1 for a wide output) and add them with shuffles, so a narrow
//   output (A = 1) or a narrow slice (U = 8) still keeps the block busy.
//   Each lane's terms are laid out in a row and read as 16-byte vectors:
//   Wn's rows, the sample's rows, and, lane-major, the hidden layer and
//   Wo's rows (unit k = l + g m of lane l at position m of its segment),
//   each segment an odd number of vectors long so that the lanes of a
//   quarter warp read distinct banks (Wo's plain rows, 768 bytes apart,
//   would put a warp's four lane groups on the same banks).
// - Two block barriers a step: after the first product and after the
//   update.  The step's code is kept small (copy loops rolled).  A first
//   version, with a row test in every product term, remote loads of the
//   partial sums, the coefficients in the ring and its copy loops unrolled
//   (about 50 KB of code in a step), took 25 us a step at
//   octo_base_chunk28; the next (256 threads, a cluster barrier a step,
//   2-byte weight loads) 5.1 us (sampler_wide_probe.py times it beside
//   this one).
// - Any shape: whatever does not fit in shared memory (in the order
//   partial sums, sample, hidden layer, biases, ring, weights) lives in
//   device memory instead: the weights and biases are read through L2, the
//   ring is skipped (each step reads its contexts and noise directly), and
//   the partial sums, the sample and the hidden layer move to a scratch
//   buffer the wrapper allocates, partial sums stored there and read with
//   ld.global.cg behind a cluster barrier a step (release / acquire at
//   cluster scope).

// Plain-C interface, loaded with ctypes: ddpm_sampler_wide_launch returns
// the cudaError_t of the launch (0 = success) and does not synchronise;
// ddpm_sampler_wide_plan reports the blocking and the scratch it needs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 384;      // threads of a block
// The threads the sum orders are cut for: the cluster size and the lanes
// sharing a sum follow a 256-thread split of the products, so that a
// shape's sums run in the order the first version of this kernel ran them
// (its results, bit for bit) while 384 threads run them.
constexpr int kOrderThreads = 256;
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

// A 16-byte vector of T, as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float lane4(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

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
  // byte offsets in shared memory (the exchange's two barriers at off_part,
  // its partial sums 16 bytes on)
  int off_part, off_state, off_hidden, off_bias, off_ring, off_wn, off_wo;
  int stage_bytes, stage_noise;   // a ring stage: contexts, then noise
  int bulk;        // 1: the ring's stages copied by cp.async.bulk (below)
  int expect;      // bytes a barrier phase awaits (0: no st.async exchange)
  // element strides: a sample row (A rounded up to a 16-byte vector of T's
  // elements, 4 or 8 floats: the first product's vector reads); a Wn row in
  // shared memory; a lane's segment of the hidden layer (floats, whole
  // vectors of T's elements: the second product's reads) and of a Wo row
  // (elements) in the second product's lane-major layout
  int xs_rs, wn_rs, hs_seg, wo_seg;
  // float offsets in a block's scratch, and its floats
  long long scr_part, scr_state, scr_hidden, scr_block;
};

// n elements of `per` a 16-byte vector, padded to an odd number of vectors:
// segments that far apart put the 8 threads of a quarter warp reading one
// vector each on distinct banks
long long odd_vectors(long long n, long long per) {
  long long v = ceil_div(n, per);
  if (v % 2 == 0) ++v;
  return v * per;
}

// log2 of the lanes sharing one sum of k terms for n outputs: the largest
// power of two g <= 32 with g * n <= kOrderThreads and g <= k
int lanes_log2(long long n, long long k) {
  int lg = 0;
  while (lg < 5 && (2LL << lg) * n <= kOrderThreads && (2LL << lg) <= k)
    ++lg;
  return lg;
}

Plan make_plan(int steps, int batch, int hidden, int adim, int elem,
               int mode, int sms) {
  Plan p = {};
  const long long H = hidden, A = adim;
  const long long wbytes = 2 * H * A * elem;
  long long c = ceil_div(H, kOrderThreads);
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
  const long long g2 = 1LL << p.lg2, vec = 16 / elem;
  p.xs_rs = int(ceil_div(A, vec) * vec);
  p.wn_rs = int(odd_vectors(A, vec));
  p.hs_seg = int(odd_vectors(ceil_div(ceil_div(U, g2), vec) * vec, 4));
  p.wo_seg = int(odd_vectors(ceil_div(U, g2), vec));
  const long long hs_rs = g2 * p.hs_seg;   // a row of the hidden layer
  const long long wn_bytes = align16(U * p.wn_rs * elem);
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
  place(kPart, 16 + 2 * p.clusters * R * A * 4, &p.off_part);
  place(kState, 2 * R * p.xs_rs * 4, &p.off_state);
  place(kHidden, R * hs_rs * 4, &p.off_hidden);
  place(kBias, (U + A) * 4, &p.off_bias);
  // the ring: its stages' barriers (kStages x 8 bytes), then the stages
  if (stage <= kSmemBudget && place(kRing, 32 + kStages * stage, &p.off_ring))
    p.stage_bytes = int(stage);
  // one thread copies a stage by cp.async.bulk where every row it copies
  // starts and ends on 16 bytes (given 16-byte aligned tensors)
  p.bulk = (p.flags & kRing) && (H * elem) % 16 == 0 &&
           (mode != kDDPM || (A * 4) % 16 == 0);
  if (place(kWeights, wn_bytes + A * g2 * p.wo_seg * elem, &p.off_wn))
    p.off_wo = int(p.off_wn + wn_bytes);
  p.smem = int(used);
  // partial sums in shared memory and more than one block: each phase of a
  // barrier awaits every block's slot
  if ((p.flags & kPart) && p.clusters > 1)
    p.expect = int(p.clusters * R * A * 4);

  long long scr = 0;
  if (!(p.flags & kPart)) { p.scr_part = scr; scr += 2 * p.clusters * R * A; }
  if (!(p.flags & kState)) { p.scr_state = scr; scr += 2 * R * p.xs_rs; }
  if (!(p.flags & kHidden)) { p.scr_hidden = scr; scr += R * hs_rs; }
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
  // the ring's stages, kStages x stage_bytes, after a barrier each; copied
  // by one thread, its bytes completing on the stage's barrier, or (bulk
  // 0) by every thread's cp.async
  uint64_t* stage_bars = reinterpret_cast<uint64_t*>(smem + p.off_ring);
  unsigned char* stages = smem + p.off_ring + 32;
  const bool bulk = ring && p.bulk;
  const bool wres = FAST || (p.flags & kWeights);
  // the partial sums travel by st.async, each block waiting on its own
  // barrier for its C slots; otherwise (one block, or the sums in device
  // memory) by stores and a barrier of the block or the cluster
  const bool exchange = p.expect > 0;

  float* scr = scratch + (size_t(blockIdx.y) * C + c) * size_t(p.scr_block);
  // two barriers (one a buffer), then the partial sums [2][C][ROWS][A]:
  // block k writes slot k of every block's
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.off_part);
  float* part = part_s ? reinterpret_cast<float*>(smem + p.off_part + 16)
                       : scr + p.scr_part;
  float* state = state_s ? reinterpret_cast<float*>(smem + p.off_state)
                         : scr + p.scr_state;
  const int xs_rs = p.xs_rs;
  float* xf = state;                         // [ROWS][xs_rs] the sample
  float* xr = state + size_t(ROWS) * xs_rs;  // [ROWS][xs_rs] its rounding
  // the hidden layer, [ROWS][g2][hs_seg]: unit k = l + g2 m at l hs_seg + m,
  // so that lane l of a second-product group reads its terms in a row
  float* hs = hidden_s ? reinterpret_cast<float*>(smem + p.off_hidden)
                       : scr + p.scr_hidden;
  float* bn_s = reinterpret_cast<float*>(smem + p.off_bias);    // [U]
  float* bo_s = bn_s + U;                                       // [A]
  // the block's weights: Wn rows j0 .. j0 + units, wn_rs apart (padded in
  // shared memory); Wo's columns j0 .. j0 + units of each action's row, in
  // shared memory lane-major as the hidden layer, [A][g2][wo_seg]
  const T* wn_p = wres ? reinterpret_cast<const T*>(smem + p.off_wn)
                       : wn + size_t(j0) * A;
  const size_t wn_rs = wres ? size_t(p.wn_rs) : size_t(A);
  const T* wo_s = reinterpret_cast<const T*>(smem + p.off_wo);
  const size_t slot = size_t(ROWS) * A;     // one block's partial sums
  const size_t half = size_t(C) * slot;     // one of the two buffers

  const int lg1 = p.lg1, lg2 = p.lg2;
  const int g1 = 1 << lg1, g2 = 1 << lg2;
  const int hs_seg = p.hs_seg, hs_rs = g2 * hs_seg, wo_seg = p.wo_seg;
  if (wres) {
    T* wn_w = reinterpret_cast<T*>(smem + p.off_wn);
    T* wo_w = reinterpret_cast<T*>(smem + p.off_wo);
#pragma unroll 1
    for (int i = tid; i < units * A; i += kThreads) {
      const int n = i / A, k = i - n * A;
      wn_w[size_t(n) * wn_rs + k] = wn[size_t(j0) * A + i];
    }
#pragma unroll 1
    for (int i = tid; i < A * units; i += kThreads) {
      const int a = i / units, k = i - a * units;
      wo_w[(size_t(a) * g2 + (k & (g2 - 1))) * wo_seg + (k >> lg2)] =
          wo[size_t(a) * hidden + j0 + k];
    }
  }
  if (bias_s) {
    for (int n = tid; n < units; n += kThreads)
      bn_s[n] = Cvt<T>::to_f(bn[j0 + n]);
    for (int a = tid; a < A; a += kThreads) bo_s[a] = Cvt<T>::to_f(bo[a]);
  }
  // the barriers, initialised before any block of the cluster stores or
  // any copy completes on them
  if (tid == 0) {
    if (exchange) {
      mbar_init(bars, 1);
      mbar_init(bars + 1, 1);
    }
    if (bulk)
      for (int i = 0; i < kStages; ++i) mbar_init(stage_bars + i, 1);
    mbar_init_fence();
  }
  if (exchange)
    cluster_barrier();
  else
    __syncthreads();
  uint32_t stage_phase = 0u;   // bit i: the parity stage i awaits next

  int seq = 0;   // the steps run so far, over row groups: barrier phases
#pragma unroll 1
  for (int grp = blockIdx.y; grp < p.groups; grp += gridDim.y) {
    const int r0 = grp * ROWS;
    const int rows = batch - r0 < ROWS ? batch - r0 : ROWS;
    const int pairs = rows * A;

    // stage s of the ring: its rows' contexts and noise
    const auto issue = [&](int s) {
      if (!ring || s >= steps) return;
      unsigned char* st = stages + (s % kStages) * p.stage_bytes;
      if (bulk) {
        if (tid == 0) {
          uint64_t* bar = stage_bars + s % kStages;
          mbar_expect(bar, uint32_t(rows * units * sizeof(T) +
                                    (MODE == kDDPM ? pairs * 4 : 0)));
#pragma unroll 1
          for (int r = 0; r < rows; ++r)
            bulk_copy(st + size_t(r) * U * sizeof(T),
                      ctx + (size_t(s) * batch + r0 + r) * hidden + j0,
                      uint32_t(units * sizeof(T)), bar);
          if (MODE == kDDPM)
            bulk_copy(st + p.stage_noise,
                      noise + (size_t(s) * batch + r0) * A,
                      uint32_t(pairs * 4), bar);
        }
        return;
      }
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
      const int r = i / A, at = r * xs_rs + (i - r * A);
      const float x = i < pairs ? noisy[size_t(r0) * A + i] : 0.f;
      xf[at] = x;
      xr[at] = rnd<T>(x);
    }
    // the first kStages - 1 steps' stages
#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

#pragma unroll 1
    for (int t = 0; t < steps; ++t, ++seq) {
      issue(t + kStages - 1);
      __pipeline_commit();
      const int bi = seq & 1;   // this step's buffer and barrier
      if (exchange && tid == 0) mbar_expect(bars + bi, uint32_t(p.expect));
      // this step's coefficients, read now and used after both products
      const float* cf = coeffs + size_t(t) * ncoef;
      const float c0 = __ldg(cf), c1 = __ldg(cf + 1), c2 = __ldg(cf + 2);
      const float c3 = MODE == kDDPM ? 0.f : __ldg(cf + ncoef - 1);
      const unsigned char* st = stages + (t % kStages) * p.stage_bytes;
      if (bulk) {   // this step's stage has landed
        const int slot = t % kStages;
        mbar_wait(stage_bars + slot, (stage_phase >> slot) & 1);
        stage_phase ^= 1u << slot;
      }
      const T* ctx_t = ring ? reinterpret_cast<const T*>(st)
                            : ctx + (size_t(t) * batch + r0) * hidden + j0;
      const size_t ctx_rs = ring ? size_t(U) : size_t(hidden);

      // h[r][n] = relu(cd(cd(cd(x[r] . Wn[n]) + bn[n]) + ctx[t][r][n])),
      // each sum in k order (lane l of g1 taking k = l, l + g1, ...)
#pragma unroll 1
      for (int n0 = 0; n0 < units; n0 += kThreads >> lg1) {
        const int n = n0 + (tid >> lg1);
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
        if (n < units) {
          const T* w = wn_p + size_t(n) * wn_rs;
          if (FAST && g1 == 1) {
            // 16-byte vectors of the padded row and of the sample rows
#pragma unroll 1
            for (int k0 = 0; k0 < A; k0 += Vec<T>::N) {
              float wf[Vec<T>::N];
              Vec<T>::unpack(*reinterpret_cast<const uint4*>(w + k0), wf);
#pragma unroll
              for (int kk = 0; kk < Vec<T>::N; kk += 4) {
                float4 xv[ROWS];
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                  xv[r] = *reinterpret_cast<const float4*>(
                      xr + r * xs_rs + k0 + kk);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (k0 + kk + j < A) {
#pragma unroll
                    for (int r = 0; r < ROWS; ++r)
                      acc[r] = fmaf(lane4(xv[r], j), wf[kk + j], acc[r]);
                  }
                }
              }
            }
          } else {
#pragma unroll 4
            for (int k = tid & (g1 - 1); k < A; k += g1) {
              const float wv = Cvt<T>::to_f(w[k]);
#pragma unroll
              for (int r = 0; r < ROWS; ++r)
                acc[r] = fmaf(xr[r * xs_rs + k], wv, acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = lane_sum(acc[r], lg1);
        if ((tid & (g1 - 1)) == 0 && n < units) {
          const float b = bias_s ? bn_s[n] : Cvt<T>::to_f(bn[j0 + n]);
          float* hn = hs + (n & (g2 - 1)) * hs_seg + (n >> lg2);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float h = rnd<T>(rnd<T>(acc[r]) + b);
            const float cv = r < rows ? Cvt<T>::to_f(ctx_t[r * ctx_rs + n])
                                      : 0.f;
            hn[r * hs_rs] = fmaxf(rnd<T>(h + cv), 0.f);
          }
        }
      }
      __syncthreads();

      // the block's partial eps[r][a] = sum over its units of h . Wo[a],
      // lane l of g2 taking units l, l + g2, ... in order, into slot c of
      // every block of the cluster (every lane of a group holds the sum:
      // lane l sends to blocks l, l + g2, ...)
      const size_t buf = bi * half + size_t(c) * slot;
#pragma unroll 1
      for (int a0 = 0; a0 < A; a0 += kThreads >> lg2) {
        const int a = a0 + (tid >> lg2), lane = tid & (g2 - 1);
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
        if (a < A) {
          const int cnt = lane < units ? ((units - 1 - lane) >> lg2) + 1 : 0;
          const float* hl = hs + lane * hs_seg;
          if (FAST) {
            const T* wl = wo_s + (size_t(a) * g2 + lane) * wo_seg;
#pragma unroll 1
            for (int m0 = 0; m0 < cnt; m0 += Vec<T>::N) {
              float wf[Vec<T>::N];
              Vec<T>::unpack(*reinterpret_cast<const uint4*>(wl + m0), wf);
#pragma unroll
              for (int kk = 0; kk < Vec<T>::N; kk += 4) {
                float4 hv[ROWS];
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                  hv[r] = *reinterpret_cast<const float4*>(
                      hl + r * hs_rs + m0 + kk);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (m0 + kk + j < cnt) {
#pragma unroll
                    for (int r = 0; r < ROWS; ++r)
                      acc[r] = fmaf(lane4(hv[r], j), wf[kk + j], acc[r]);
                  }
                }
              }
            }
          } else {
            // Wo lane-major in shared memory, or its row in device memory
            const T* wl = wres ? wo_s + (size_t(a) * g2 + lane) * wo_seg
                               : wo + size_t(a) * hidden + j0 + lane;
            const int ws = wres ? 1 : g2;
#pragma unroll 4
            for (int m = 0; m < cnt; ++m) {
              const float wv = Cvt<T>::to_f(wl[m * ws]);
#pragma unroll
              for (int r = 0; r < ROWS; ++r)
                acc[r] = fmaf(hl[r * hs_rs + m], wv, acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = lane_sum(acc[r], lg2);
        if (a < A && exchange) {
#pragma unroll 1
          for (int k = lane; k < C; k += g2) {
            const uint32_t bar = peer_addr(bars + bi, k);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              st_async(peer_addr(part + buf + r * A + a, k), acc[r], bar);
          }
        } else if (a < A && lane == 0) {
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
      if (exchange)
        mbar_wait(bars + bi, (seq >> 1) & 1);
      else if (C > 1)
        cluster_barrier();
      else
        __syncthreads();

      // eps = the cluster's partials in rank order; the update
      const float* nz =
          MODE != kDDPM ? nullptr
          : ring ? reinterpret_cast<const float*>(st + p.stage_noise)
                 : noise + (size_t(t) * batch + r0) * A;
      const float* pr = part + bi * half;
#pragma unroll 1
      for (int i = tid; i < pairs; i += kThreads) {
        float e = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k)
          if (k < C)
            e += part_s ? pr[k * slot + i] : __ldcg(pr + k * slot + i);
        const int r = i / A, a = i - r * A, at = r * xs_rs + a;
        const float b = bias_s ? bo_s[a] : Cvt<T>::to_f(bo[a]);
        float eps = rnd<T>(rnd<T>(e) + b);
        const float x = xf[at];
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
        xf[at] = nx;
        xr[at] = rnd<T>(nx);
      }
      __pipeline_wait_prior(kStages - 2);
      __syncthreads();
    }

    if (c == 0)
      for (int i = tid; i < pairs; i += kThreads)
        out[size_t(r0) * A + i] = xf[(i / A) * xs_rs + i % A];
    // every block has read the last step's partial sums before any starts
    // the next row group (storing into the others) or leaves
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

// The launch's cut, into out[0 .. 15]: clusters, units, rows, groups,
// grid_y, g1, g2, flags, shared memory bytes, scratch floats (all blocks),
// blocks, the bytes a barrier phase awaits (0: no st.async exchange),
// threads a block, bulk (1: the ring's stages by cp.async.bulk, given
// 16-byte aligned tensors), the floats of a sample row and of a lane's
// segment of the hidden layer.  elem = compute dtype size; sms = the card's
// SM count.  Returns a cudaError_t (cudaErrorInvalidValue for a shape it
// cannot take).
int ddpm_sampler_wide_plan(int steps, int batch, int hidden, int adim,
                           int elem, int mode, int sms, long long* out) {
  if (!valid(steps, batch, hidden, adim, elem, mode, sms))
    return int(cudaErrorInvalidValue);
  const Plan p = make_plan(steps, batch, hidden, adim, elem, mode, sms);
  const long long blocks = (long long)p.clusters * p.grid_y;
  const long long v[16] = {p.clusters, p.units, p.rows, p.groups, p.grid_y,
                           1 << p.lg1, 1 << p.lg2, p.flags, p.smem,
                           blocks * p.scr_block, blocks, p.expect, kThreads,
                           p.bulk, p.xs_rs, p.hs_seg};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
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
  Plan p = make_plan(steps, batch, hidden, adim, elem, mode, sms);
  if (p.scr_block > 0 && scratch == nullptr)
    return int(cudaErrorInvalidValue);
  // a bulk copy needs its source on 16 bytes too
  if ((reinterpret_cast<uintptr_t>(ctx) & 15) ||
      (mode == kDDPM && (reinterpret_cast<uintptr_t>(noise) & 15)))
    p.bulk = 0;
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
