// What the flash-attention kernels share: flash_attention.cu (head dims up
// to 256) and flash_attention_wide.cu (every head dim above 256) include it;
// grouped_experts.cu takes its cp.async, ldmatrix and wgmma helpers.
// Dtype conversion, the Philox dropout counter and its per-block offset, the
// launch arguments, cp.async staging, ldmatrix / mma.sync m16n8k16 operands
// and products, the 2^x exponent, the float32 CUDA-core tile helpers, and
// wgmma's shared-memory descriptor and m64n128k16 product.
// Each source note says how its kernels use them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  // added to the block's b*H + h in the Philox counter: (b0 + b)*H_total +
  // h0 - b*H, so that the counter is (b0 + b)*H_total + h0 + h
  uint32_t bh0;
  float inv_keep;
  bool on;
  __device__ __forceinline__ bool keep(uint32_t bh, uint32_t row,
                                       uint32_t col) const {
    const uint4 w =
        philox4x32_10(make_uint4(col >> 2, row, bh + bh0, 0u), k0, k1);
    const uint32_t lane = col & 3u;
    const uint32_t bits =
        lane == 0 ? w.x : (lane == 1 ? w.y : (lane == 2 ? w.z : w.w));
    return bits >= threshold;
  }
};

struct Args {
  int batch, seq, heads, s_pad;
  float scale;
  uint32_t bh0;          // b0 * heads_total + h0: the launch's first counter
  uint32_t heads_total;  // the heads of the whole attention (H_total)
};

// Every grid is (tiles, heads, batch): blockIdx.z is the block's batch row.
__device__ __forceinline__ Dropout make_dropout(const int64_t* seed,
                                                uint32_t threshold,
                                                float inv_keep, int on,
                                                const Args& a) {
  Dropout d;
  d.on = on != 0;
  d.k0 = d.on ? static_cast<uint32_t>(seed[0]) : 0u;
  d.k1 = d.on ? static_cast<uint32_t>(seed[1]) : 0u;
  d.bh0 = a.bh0 +
          blockIdx.z * (a.heads_total - static_cast<uint32_t>(a.heads));
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

// -- the tensor-core forward (bf16, fp16) -------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b for one m16n8k16 tile, float32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to T (to nearest even) in one 32-bit word, lo in the low
// half: the element order of an mma operand and of two neighbouring columns
// in memory.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring output columns at dst: rounded to T into one 32-bit word,
// or, with O = float, stored as float32 (the ring-attention partials, which
// the ring merges or sums before any rounding).
template <typename T, typename O>
__device__ __forceinline__ void store2(O* dst, float lo, float hi) {
  if constexpr (std::is_same<O, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(lo, hi);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x by the special-function unit (flushes subnormal results to zero).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// rows [row0, row0 + ROWS) of a (B, S, H, D) slice into a shared tile of
// row stride LDT, by 16-byte cp.async; rows at or past S are zero-filled.
template <typename T, int D, int ROWS, int LDT, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int seq, size_t row_stride) {
  constexpr int CPR = D * sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < (ROWS * CPR + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c < ROWS * CPR) {
      const int r = c / CPR, ch = c % CPR;
      const int row = row0 + r;
      const bool in = row < seq;
      cp_async16(dst + r * LDT + ch * PER,
                 src + static_cast<size_t>(in ? row : 0) * row_stride +
                     ch * PER,
                 in);
    }
  }
}

// -- the tensor-core backward (bf16, fp16) ------------------------------------

// 8 x 8 matrices 0 and 1 of an ldmatrix: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c[n] = A B^T over depth D for one warp: A the 16 rows of a shared tile at
// a, B the NN * 8 rows at b (row stride LDT each), both by ldmatrix, the way
// the forward takes Q and K.
template <typename T, int D, int LDT, int NN>
__device__ __forceinline__ void warp_rows_dot(float (&c)[NN][4], const T* a,
                                              const T* b, int lane) {
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int n = 0; n < NN; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (l8 * 8 + lr) * LDT + kk * 16 + l16 * 8);
    if constexpr (NN == 1) {
      uint32_t bf[2];
      ldsm_x2(bf, b + lr * LDT + kk * 16 + l8 * 8);
      mma16816<T>(c[0], af, bf[0], bf[1]);
    } else {
      static_assert(NN % 2 == 0, "n8 tiles in pairs");
#pragma unroll
      for (int n2 = 0; n2 < NN / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, b + (n2 * 16 + l16 * 8 + lr) * LDT + kk * 16 + l8 * 8);
        mma16816<T>(c[2 * n2], af, bf[0], bf[1]);
        mma16816<T>(c[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// o[n] += A B for one warp and one k16 step: A the fragment af (the warp's
// 16 rows, the step's 16 columns), B the step's 16 rows of a shared tile at
// b (row stride LDT, b at the warp's first output column), by
// ldmatrix.trans, the way the forward takes V.
template <typename T, int LDT, int NO>
__device__ __forceinline__ void warp_step_dot(float (&o)[NO][4],
                                              const uint32_t (&af)[4],
                                              const T* b, int lane) {
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int n2 = 0; n2 < NO / 2; ++n2) {
    uint32_t bf[4];
    ldsm_x4_trans(bf, b + (l8 * 8 + lr) * LDT + n2 * 16 + l16 * 8);
    mma16816<T>(o[2 * n2], af, bf[0], bf[1]);
    mma16816<T>(o[2 * n2 + 1], af, bf[2], bf[3]);
  }
}

// The A fragment of k16 step kk from the accumulators c (their n8 tiles
// 2 kk and 2 kk + 1), rounded to T: the cast of the JAX kernel.
template <typename T, int NN>
__device__ __forceinline__ void acc_to_a(uint32_t (&af)[4],
                                         const float (&c)[NN][4], int kk) {
  af[0] = pack2<T>(c[2 * kk][0], c[2 * kk][1]);
  af[1] = pack2<T>(c[2 * kk][2], c[2 * kk][3]);
  af[2] = pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  af[3] = pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// x[i] for an index i in 0..3 known only at run time, by selects (an array
// indexed so would go to local memory).
__device__ __forceinline__ uint32_t pick4(const uint32_t (&x)[4], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
}

// A ROWS x COLS int8 tile of the mask (row stride s_pad) into shared rows of
// stride LDM, by 16-byte cp.async.
template <int ROWS, int COLS, int LDM, int NT>
__device__ __forceinline__ void stage_mask(int8_t* dst, const int8_t* src,
                                           int s_pad) {
  constexpr int CH = COLS / 16;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c < ROWS * CH) {
      const int r = c / CH, ch = c % CH;
      cp_async16(dst + r * LDM + ch * 16,
                 src + static_cast<size_t>(r) * s_pad + ch * 16, true);
    }
  }
}

// N floats into shared memory by 16-byte cp.async.
template <int N, int NT>
__device__ __forceinline__ void stage_floats(float* dst, const float* src) {
  for (int c = threadIdx.x; c < N / 4; c += NT)
    cp_async16(dst + 4 * c, src + 4 * c, true);
}

struct Launch {
  int batch, seq, heads, s_pad;
  float scale, inv_keep;
  uint32_t threshold;
  int dropout;
  cudaStream_t stream;
  int out_f32;  // 16-bit inputs: store the outputs as float32
  uint32_t bh0;          // b0 * heads_total + h0 (Args::bh0)
  uint32_t heads_total;  // Args::heads_total
};

template <typename Kern>
int launch_config(Kern kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool offsets_ok(int b0, int h0, int heads, int heads_total) {
  return b0 >= 0 && h0 >= 0 && heads_total >= h0 + heads;
}

// -- wgmma (sm_90a) ------------------------------------------------------------

// A wgmma descriptor of a swizzled tile in shared memory (128-byte swizzle;
// lbo, sbo in bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A B for the warpgroup, N = 128: A (64 x 16) from each warp's mma.sync
// A fragment a, B (16 x 128) by the descriptor, TRANS_B for a B stored
// N-major; d in the m16n8 accumulator layout of each warp's 16 rows.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, const __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, const __half*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

}  // namespace
