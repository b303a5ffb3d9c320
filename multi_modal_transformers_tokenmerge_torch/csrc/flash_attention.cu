// Block-sparse masked flash attention for Hopper (sm_90a): the plain
// forward, the forward that saves the row logsumexp, and the dq and dk/dv
// backward passes.
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/flash_attention.py: _flash_kernel (:60), _flash_fwd_lse_kernel (:328),
// _flash_dq_kernel (:383) and _flash_dkv_kernel (:430).  The plain PyTorch
// versions (ops/flash_attention.py: flash_*_reference) repeat this
// arithmetic step for step.
//
// flash_fwd_kernel is the forward a server runs, and the forward of the
// recompute backward: no seed, no Philox bits, no LSE store.  The TPU
// program handles one (batch, q tile) for ALL heads, because its grid runs
// in order and fewer, fatter programs win there; here a block per (batch,
// head, q tile) fills the SMs.  At the ToMe stages of octo_deep (B=1, H=12,
// D=64, S=224/160/96) a launch is 24-48 blocks of a few key tiles each:
// the work (under 0.1 GFLOP) and the bytes (under 1 MB) bound it at a
// fraction of a microsecond, and launch latency plus the serial key-tile
// loop of one block set its time.
//
// What it computes.  q, k, v, dO are (B, S, H, D) in the input dtype; the
// static mask is an int8 (S_pad, S_pad) tile-aligned square (zero past S)
// with per-tile skip tables: k_hi[q tile] key tiles are visited by the
// forward and dq passes, the dk/dv pass visits q tiles from q_lo[k tile].
// Logits are float32 sums of input-dtype products times 1/sqrt(D), masked
// to -1e30.  Online max and sum are float32; p = exp(s - max(m, -5e29))
// keeps rows with no live key at p = 0, so they emit zeros and an LSE of
// about -1e30.  Products take the operands the JAX kernel casts: p (or
// keep * p / (1 - r)) rounded to V's dtype before PV, ds rounded to K's
// (Q's) dtype before dS K (dS^T Q).
//
// Dropout is rebuilt, not copied: the TPU re-seeds its hardware PRNG per
// tile, a stream nothing else reproduces.  The keep bit of element
// (b, h, row, col) is word (col & 3) of Philox4x32-10 at counter
// (col >> 2, row, b*H + h, 0) under the key (seed[0], seed[1]); the element
// is kept when that word is >= threshold.  Every pass regenerates the same
// mask whatever its tiles.
//
// What bounds it on the H100.  At octo_base training (B=32, S=74, H=3,
// D=256) the work is tiny (0.5 GFLOP forward) and each pass is bounded by
// its bytes (a few MB: about 1-3 us at 3.35 TB/s) and, in practice, by
// launch latency.  At the long-context shape (B=8, S=1024, H=12, D=64) the
// block-causal mask leaves some 14 GFLOP a pass, bound by the tensor cores
// (~14 us at 989 TFLOP/s bf16).  This first kernel is simple and right, not
// fast: it computes on the CUDA cores in float32 from shared memory, one
// block per (batch, head, tile) - the TPU's one program per (batch, q tile)
// looping over heads becomes one block per head, since blocks run in
// parallel on 132 SMs.  Tiles are staged in shared memory as float32 rows
// padded by four floats, so the float4 reads of a quarter warp hit distinct
// banks; each thread owns one column (key or feature) and a stride of rows,
// so one shared read of the column feeds a row of fused multiply-adds.
// Register budget: with D = 256 a 64 x 256 float32 accumulator would take
// 128 registers a thread at 128 threads, so D = 256 uses 32 x 32 tiles and
// 256 threads (32 accumulators a thread, and 64 in the dk/dv pass, which
// holds dK and dV); D = 64 uses 64 x 64 tiles and 128 threads (the same
// counts).  Tensor-core (wgmma) tiles and cp.async staging are the work of
// a later change; their absence is the gap between the measured time and
// the bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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

// x rounded through T: the cast the JAX kernel applies before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

struct Dropout {
  uint32_t k0, k1, threshold;
  float inv_keep;
  bool on;
  __device__ __forceinline__ bool keep(uint32_t bh, uint32_t row,
                                       uint32_t col) const {
    const uint4 w = philox4x32_10(make_uint4(col >> 2, row, bh, 0u), k0, k1);
    const uint32_t lane = col & 3u;
    const uint32_t bits =
        lane == 0 ? w.x : (lane == 1 ? w.y : (lane == 2 ? w.z : w.w));
    return bits >= threshold;
  }
};

__device__ __forceinline__ Dropout make_dropout(const int64_t* seed,
                                                uint32_t threshold,
                                                float inv_keep, int on) {
  Dropout d;
  d.on = on != 0;
  d.k0 = d.on ? static_cast<uint32_t>(seed[0]) : 0u;
  d.k1 = d.on ? static_cast<uint32_t>(seed[1]) : 0u;
  d.threshold = threshold;
  d.inv_keep = inv_keep;
  return d;
}

// Rows [row0, row0 + ROWS) of a (B, S, H, D) tensor's (b, h) slice into a
// float32 shared tile with row stride D + 4; rows at or past S read 0.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int seq,
                                          size_t row_stride) {
  constexpr int LD = D + 4;
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * LD + d] =
        row < seq ? Cvt<T>::to_f(src[static_cast<size_t>(row) * row_stride + d])
                  : 0.f;
  }
}

// Each thread owns key column c = tid % BK of a BQ x BK tile and rows
// r0 + i * (NT / BK).  acc_a[i] = Qa[r] . Kb[c]; with TWO also
// acc_c[i] = Qc[r] . Kd[c] (the logits and dO V^T of the backward).
template <int D, int BQ, int BK, int NT, bool TWO>
__device__ __forceinline__ void tile_dots(const float* qa, const float* kb,
                                          const float* qc, const float* kd,
                                          float* acc_a, float* acc_c) {
  constexpr int LD = D + 4;
  constexpr int RSTEP = NT / BK;
  constexpr int NS = BQ / RSTEP;
  const int c = threadIdx.x % BK, r0 = threadIdx.x / BK;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    acc_a[i] = 0.f;
    if (TWO) acc_c[i] = 0.f;
  }
  for (int d = 0; d < D; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(&kb[c * LD + d]);
    float4 kw;
    if (TWO) kw = *reinterpret_cast<const float4*>(&kd[c * LD + d]);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = r0 + i * RSTEP;
      const float4 a = *reinterpret_cast<const float4*>(&qa[r * LD + d]);
      acc_a[i] = fmaf(a.x, kv.x, acc_a[i]);
      acc_a[i] = fmaf(a.y, kv.y, acc_a[i]);
      acc_a[i] = fmaf(a.z, kv.z, acc_a[i]);
      acc_a[i] = fmaf(a.w, kv.w, acc_a[i]);
      if (TWO) {
        const float4 b = *reinterpret_cast<const float4*>(&qc[r * LD + d]);
        acc_c[i] = fmaf(b.x, kw.x, acc_c[i]);
        acc_c[i] = fmaf(b.y, kw.y, acc_c[i]);
        acc_c[i] = fmaf(b.z, kw.z, acc_c[i]);
        acc_c[i] = fmaf(b.w, kw.w, acc_c[i]);
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  int batch, seq, heads, s_pad;
  float scale;
};

// The forward pass of one (batch, head, q tile) block.  With DROPOUT the
// kept weights are rescaled and the rest zeroed before P V (l and the LSE
// use the undropped p); without it no Philox code is compiled in.  lse may
// be null: then no row statistic is stored.
template <typename T, int D, int BQ, int BK, int NT, bool DROPOUT>
__device__ __forceinline__ void forward_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int8_t* __restrict__ mask, const int32_t* __restrict__ k_hi,
    T* __restrict__ out, float* __restrict__ lse, const Args& a,
    const Dropout& drop) {
  constexpr int LD = D + 4, LP = BK + 4;
  constexpr int RSTEP = NT / BK, NS = BQ / RSTEP;
  constexpr int DSTEP = NT / D, NACC = BQ / DSTEP;
  constexpr int NW = NT / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sM = sP + BQ * LP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = a.heads;
  const int q0 = qt * BQ;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * D;

  load_tile<T, D, BQ, NT>(sQ, q + base, q0, a.seq, row_stride);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  const int dcol = threadIdx.x % D, drow = threadIdx.x / D;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  const int n_k = k_hi[qt];
  const int c = threadIdx.x % BK, r0 = threadIdx.x / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D, BK, NT>(sK, k + base, k0, a.seq, row_stride);
    load_tile<T, D, BK, NT>(sV, v + base, k0, a.seq, row_stride);
    __syncthreads();
    float s[NS];
    tile_dots<D, BQ, BK, NT, false>(sQ, sK, nullptr, nullptr, s, nullptr);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = r0 + i * RSTEP;
      const float x = s[i] * a.scale;
      const bool live =
          mask[static_cast<size_t>(q0 + r) * a.s_pad + k0 + c] != 0;
      sP[r * LP + c] = live ? x : kNegInf;
    }
    __syncthreads();
    // row statistics: one warp a row
    for (int r = warp; r < BQ; r += NW) {
      float mx = kNegInf;
      for (int cc = lane; cc < BK; cc += 32) mx = fmaxf(mx, sP[r * LP + cc]);
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float ref = fmaxf(m_new, 0.5f * kNegInf);
      float sum = 0.f;
      for (int cc = lane; cc < BK; cc += 32) {
        const float pv = expf(sP[r * LP + cc] - ref);
        sum += pv;
        float pa = pv;
        if (DROPOUT && drop.on)
          pa = drop.keep(bh, q0 + r, k0 + cc) ? pv * drop.inv_keep : 0.f;
        sP[r * LP + cc] = round_to<T>(pa);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] *= sA[drow + j * DSTEP];
    for (int cc = 0; cc < BK; cc += 4) {
      const float v0 = sV[(cc + 0) * LD + dcol];
      const float v1 = sV[(cc + 1) * LD + dcol];
      const float v2 = sV[(cc + 2) * LD + dcol];
      const float v3 = sV[(cc + 3) * LD + dcol];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const float4 pp = *reinterpret_cast<const float4*>(
            &sP[(drow + j * DSTEP) * LP + cc]);
        acc[j] = fmaf(pp.x, v0, acc[j]);
        acc[j] = fmaf(pp.y, v1, acc[j]);
        acc[j] = fmaf(pp.z, v2, acc[j]);
        acc[j] = fmaf(pp.w, v3, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int r = drow + j * DSTEP;
    const int row = q0 + r;
    if (row < a.seq) {
      const float l_safe = fmaxf(sL[r], 1e-30f);
      out[base + static_cast<size_t>(row) * row_stride + dcol] =
          Cvt<T>::from_f(acc[j] / l_safe);
    }
  }
  if (lse != nullptr)
    for (int r = threadIdx.x; r < BQ; r += NT)
      lse[static_cast<size_t>(bh) * a.s_pad + q0 + r] =
          sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_fwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int8_t* __restrict__ mask,
                         const int32_t* __restrict__ k_hi,
                         const int64_t* __restrict__ seed, T* __restrict__ out,
                         float* __restrict__ lse, Args a, uint32_t threshold,
                         float inv_keep, int dropout) {
  forward_block<T, D, BQ, BK, NT, true>(
      q, k, v, mask, k_hi, out, lse, a,
      make_dropout(seed, threshold, inv_keep, dropout));
}

// The forward without LSE and without dropout: what the JAX package's
// _flash_kernel computes.  A __global__ entry of its own that takes no seed,
// compiles no Philox code and stores no row statistic; p is rounded to V's
// dtype before P V, and the reference of the exponent is clamped at -5e29 so
// a row with no live key keeps p = 0 and emits zeros.
template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int8_t* __restrict__ mask,
                     const int32_t* __restrict__ k_hi, T* __restrict__ out,
                     Args a) {
  forward_block<T, D, BQ, BK, NT, false>(q, k, v, mask, k_hi, out, nullptr,
                                         a, Dropout{});
}

template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int8_t* __restrict__ mask,
                    const int32_t* __restrict__ k_hi,
                    const int64_t* __restrict__ seed, T* __restrict__ dq,
                    Args a, uint32_t threshold, float inv_keep, int dropout) {
  constexpr int LD = D + 4, LP = BK + 4;
  constexpr int RSTEP = NT / BK, NS = BQ / RSTEP;
  constexpr int DSTEP = NT / D, NACC = BQ / DSTEP;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BQ * LD;
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sLse = sS + BQ * LP;
  float* sDelta = sLse + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = a.heads;
  const int q0 = qt * BQ;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * D;
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout);

  load_tile<T, D, BQ, NT>(sQ, q + base, q0, a.seq, row_stride);
  load_tile<T, D, BQ, NT>(sO, dout + base, q0, a.seq, row_stride);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    sLse[r] = lse[static_cast<size_t>(bh) * a.s_pad + q0 + r];
    sDelta[r] = delta[static_cast<size_t>(bh) * a.s_pad + q0 + r];
  }
  const int dcol = threadIdx.x % D, drow = threadIdx.x / D;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  const int n_k = k_hi[qt];
  const int c = threadIdx.x % BK, r0 = threadIdx.x / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D, BK, NT>(sK, k + base, k0, a.seq, row_stride);
    load_tile<T, D, BK, NT>(sV, v + base, k0, a.seq, row_stride);
    __syncthreads();
    float s[NS], dp[NS];
    tile_dots<D, BQ, BK, NT, true>(sQ, sK, sO, sV, s, dp);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = r0 + i * RSTEP;
      const bool allowed =
          mask[static_cast<size_t>(q0 + r) * a.s_pad + k0 + c] != 0;
      const float x = allowed ? s[i] * a.scale : kNegInf;
      const float row_lse = sLse[r];
      const float p = row_lse > 0.25f * kNegInf ? expf(x - row_lse) : 0.f;
      float g = dp[i];
      if (drop.on) g = drop.keep(bh, q0 + r, k0 + c) ? g * drop.inv_keep : 0.f;
      sS[r * LP + c] = round_to<T>(p * (g - sDelta[r]));
    }
    __syncthreads();
    for (int cc = 0; cc < BK; cc += 4) {
      const float k0v = sK[(cc + 0) * LD + dcol];
      const float k1v = sK[(cc + 1) * LD + dcol];
      const float k2v = sK[(cc + 2) * LD + dcol];
      const float k3v = sK[(cc + 3) * LD + dcol];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const float4 ds = *reinterpret_cast<const float4*>(
            &sS[(drow + j * DSTEP) * LP + cc]);
        acc[j] = fmaf(ds.x, k0v, acc[j]);
        acc[j] = fmaf(ds.y, k1v, acc[j]);
        acc[j] = fmaf(ds.z, k2v, acc[j]);
        acc[j] = fmaf(ds.w, k3v, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int row = q0 + drow + j * DSTEP;
    if (row < a.seq)
      dq[base + static_cast<size_t>(row) * row_stride + dcol] =
          Cvt<T>::from_f(acc[j] * a.scale);
  }
}

template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int8_t* __restrict__ mask,
                     const int32_t* __restrict__ q_lo,
                     const int64_t* __restrict__ seed, T* __restrict__ dk,
                     T* __restrict__ dv, Args a, uint32_t threshold,
                     float inv_keep, int dropout) {
  constexpr int LD = D + 4, LP = BK + 4;
  constexpr int RSTEP = NT / BK, NS = BQ / RSTEP;
  constexpr int DSTEP = NT / D, NACC = BK / DSTEP;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;
  float* sPd = sO + BQ * LD;
  float* sS = sPd + BQ * LP;
  float* sLse = sS + BQ * LP;
  float* sDelta = sLse + BQ;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = a.heads;
  const int k0 = kt * BK;
  const int num_q = a.s_pad / BQ;
  const uint32_t bh = static_cast<uint32_t>(b * H + h);
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * D;
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout);

  load_tile<T, D, BK, NT>(sK, k + base, k0, a.seq, row_stride);
  load_tile<T, D, BK, NT>(sV, v + base, k0, a.seq, row_stride);
  const int dcol = threadIdx.x % D, dkrow = threadIdx.x / D;
  float acc_k[NACC], acc_v[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    acc_k[j] = 0.f;
    acc_v[j] = 0.f;
  }
  const int c = threadIdx.x % BK, r0 = threadIdx.x / BK;
  for (int qt = q_lo[kt]; qt < num_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D, BQ, NT>(sQ, q + base, q0, a.seq, row_stride);
    load_tile<T, D, BQ, NT>(sO, dout + base, q0, a.seq, row_stride);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      sLse[r] = lse[static_cast<size_t>(bh) * a.s_pad + q0 + r];
      sDelta[r] = delta[static_cast<size_t>(bh) * a.s_pad + q0 + r];
    }
    __syncthreads();
    float s[NS], dp[NS];
    tile_dots<D, BQ, BK, NT, true>(sQ, sK, sO, sV, s, dp);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = r0 + i * RSTEP;
      const bool allowed =
          mask[static_cast<size_t>(q0 + r) * a.s_pad + k0 + c] != 0;
      const float x = allowed ? s[i] * a.scale : kNegInf;
      const float row_lse = sLse[r];
      const float p = row_lse > 0.25f * kNegInf ? expf(x - row_lse) : 0.f;
      float pd = p, g = dp[i];
      if (drop.on) {
        const bool kept = drop.keep(bh, q0 + r, k0 + c);
        pd = kept ? p * drop.inv_keep : 0.f;
        g = kept ? g * drop.inv_keep : 0.f;
      }
      sPd[r * LP + c] = round_to<T>(pd);
      sS[r * LP + c] = round_to<T>(p * (g - sDelta[r]));
    }
    __syncthreads();
    for (int r = 0; r < BQ; ++r) {
      const float o = sO[r * LD + dcol];
      const float qq = sQ[r * LD + dcol];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int cj = dkrow + j * DSTEP;
        acc_v[j] = fmaf(sPd[r * LP + cj], o, acc_v[j]);
        acc_k[j] = fmaf(sS[r * LP + cj], qq, acc_k[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int row = k0 + dkrow + j * DSTEP;
    if (row < a.seq) {
      const size_t at = base + static_cast<size_t>(row) * row_stride + dcol;
      dk[at] = Cvt<T>::from_f(acc_k[j] * a.scale);
      dv[at] = Cvt<T>::from_f(acc_v[j]);
    }
  }
}

template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int BQ = 64, BK = 64, NT = 128;
};
template <>
struct Tiles<256> {
  static constexpr int BQ = 32, BK = 32, NT = 256;
};

template <int D>
constexpr size_t fwd_smem() {
  using Tl = Tiles<D>;
  return sizeof(float) * ((Tl::BQ + 2 * Tl::BK) * (D + 4) +
                          Tl::BQ * (Tl::BK + 4) + 3 * Tl::BQ);
}
template <int D>
constexpr size_t dq_smem() {
  using Tl = Tiles<D>;
  return sizeof(float) * ((2 * Tl::BQ + 2 * Tl::BK) * (D + 4) +
                          Tl::BQ * (Tl::BK + 4) + 2 * Tl::BQ);
}
template <int D>
constexpr size_t dkv_smem() {
  using Tl = Tiles<D>;
  return sizeof(float) * ((2 * Tl::BQ + 2 * Tl::BK) * (D + 4) +
                          2 * Tl::BQ * (Tl::BK + 4) + 2 * Tl::BQ);
}

struct Launch {
  int batch, seq, heads, s_pad;
  float scale, inv_keep;
  uint32_t threshold;
  int dropout;
  cudaStream_t stream;
};

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const int8_t* mask,
        const int32_t* k_hi, const int64_t* seed, void* out, float* lse,
        const Launch& L) {
  using Tl = Tiles<D>;
  auto kern = flash_fwd_lse_kernel<T, D, Tl::BQ, Tl::BK, Tl::NT>;
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L.s_pad / Tl::BQ, L.heads, L.batch);
  kern<<<grid, Tl::NT, smem, L.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, k_hi, seed, static_cast<T*>(out), lse,
      Args{L.batch, L.seq, L.heads, L.s_pad, L.scale}, L.threshold,
      L.inv_keep, L.dropout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd_plain(const void* q, const void* k, const void* v, const int8_t* mask,
              const int32_t* k_hi, void* out, const Launch& L) {
  using Tl = Tiles<D>;
  auto kern = flash_fwd_kernel<T, D, Tl::BQ, Tl::BK, Tl::NT>;
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L.s_pad / Tl::BQ, L.heads, L.batch);
  kern<<<grid, Tl::NT, smem, L.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, k_hi, static_cast<T*>(out),
      Args{L.batch, L.seq, L.heads, L.s_pad, L.scale});
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, const int8_t* mask,
       const int32_t* k_hi, const int64_t* seed, void* dqp, const Launch& L) {
  using Tl = Tiles<D>;
  auto kern = flash_dq_kernel<T, D, Tl::BQ, Tl::BK, Tl::NT>;
  const size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L.s_pad / Tl::BQ, L.heads, L.batch);
  kern<<<grid, Tl::NT, smem, L.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      k_hi, seed, static_cast<T*>(dqp),
      Args{L.batch, L.seq, L.heads, L.s_pad, L.scale}, L.threshold,
      L.inv_keep, L.dropout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int8_t* mask,
        const int32_t* q_lo, const int64_t* seed, void* dkp, void* dvp,
        const Launch& L) {
  using Tl = Tiles<D>;
  auto kern = flash_dkv_kernel<T, D, Tl::BQ, Tl::BK, Tl::NT>;
  const size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L.s_pad / Tl::BK, L.heads, L.batch);
  kern<<<grid, Tl::NT, smem, L.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      q_lo, seed, static_cast<T*>(dkp), static_cast<T*>(dvp),
      Args{L.batch, L.seq, L.heads, L.s_pad, L.scale}, L.threshold,
      L.inv_keep, L.dropout);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int head_dim, int s_pad, int seq) {
  int bq, bk;
  if (head_dim == 64) {
    bq = Tiles<64>::BQ;
    bk = Tiles<64>::BK;
  } else if (head_dim == 256) {
    bq = Tiles<256>::BQ;
    bk = Tiles<256>::BK;
  } else {
    return false;
  }
  return seq > 0 && seq <= s_pad && s_pad % bq == 0 && s_pad % bk == 0;
}

// Dispatch on (dtype code, head dim): 0 float32, 1 bfloat16, 2 float16.
#define FLASH_DISPATCH(FN, ...)                                   \
  switch (dtype * 1000 + head_dim) {                              \
    case 64: return FN<float, 64>(__VA_ARGS__);                   \
    case 256: return FN<float, 256>(__VA_ARGS__);                 \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    case 1256: return FN<__nv_bfloat16, 256>(__VA_ARGS__);        \
    case 2064: return FN<__half, 64>(__VA_ARGS__);                \
    case 2256: return FN<__half, 256>(__VA_ARGS__);               \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of the launch (0 on success) and
// never synchronises.  q, k, v, dout, out, dq, dk, dv are (B, S, H, D)
// contiguous in the dtype; lse and delta (B, H, S_pad) float32; mask
// (S_pad, S_pad) int8; k_hi / q_lo int32; seed two int64 words (read only
// when dropout is set).  flash_fwd_launch takes no seed and writes no LSE.

int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const int8_t* mask, const int32_t* k_hi, void* out,
                     int batch, int seq, int heads, int head_dim, int s_pad,
                     int dtype, float scale, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, 1.f, 0u, 0,
                 static_cast<cudaStream_t>(stream)};
  FLASH_DISPATCH(fwd_plain, q, k, v, mask, k_hi, out, L)
}

int flash_fwd_lse_launch(const void* q, const void* k, const void* v,
                         const int8_t* mask, const int32_t* k_hi,
                         const int64_t* seed, void* out, float* lse, int batch,
                         int seq, int heads, int head_dim, int s_pad,
                         int dtype, float scale, float inv_keep,
                         uint32_t threshold, int dropout, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq) || (dropout && !seed))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                 dropout, static_cast<cudaStream_t>(stream)};
  FLASH_DISPATCH(fwd, q, k, v, mask, k_hi, seed, out, lse, L)
}

int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int8_t* mask, const int32_t* k_hi,
                    const int64_t* seed, void* dqp, int batch, int seq,
                    int heads, int head_dim, int s_pad, int dtype,
                    float scale, float inv_keep, uint32_t threshold,
                    int dropout, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq) || (dropout && !seed))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                 dropout, static_cast<cudaStream_t>(stream)};
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, mask, k_hi, seed, dqp, L)
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int8_t* mask, const int32_t* q_lo,
                     const int64_t* seed, void* dkp, void* dvp, int batch,
                     int seq, int heads, int head_dim, int s_pad, int dtype,
                     float scale, float inv_keep, uint32_t threshold,
                     int dropout, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq) || (dropout && !seed))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                 dropout, static_cast<cudaStream_t>(stream)};
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, mask, q_lo, seed, dkp, dvp,
                 L)
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
