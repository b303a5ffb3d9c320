// Fused DDPM / DDIM reverse sampler for Hopper (sm_90a).
//
// Replaces the Pallas kernel ops/ddpm_sampler.py:_sampler_kernel of the JAX
// package.  For t = 0 .. T-1, on one batch row:
//
//   h   = relu(cd(cd(cd(x . Wn^T) + bn) + ctx[t]))      (cd: round to the
//   eps = f32(cd(cd(h . Wo^T) + bo))                      compute dtype)
//   DDPM:            x <- c1 * (x - c2 * eps) + c3 * noise[t]
//   DDIM raw:        x0 = clip(d1 * x - d2 * eps);        x <- e1 * x0 + e2 * eps
//   DDIM recompute:  x0 as above; eps <- (d1 * x - x0) / d2; x <- e1 * x0 + e2 * eps
//   x <- clip(x, +-clip_value)
//
// Products accumulate in float32 and the state update is float32; the
// roundings to the compute dtype sit where the JAX kernel puts them.
//
// What bounds it on this card: not bytes and not operations.  At octo_base
// (T=32, H=768, A=8, bf16) one batch row moves about 75 KB (its contexts and
// the weights) and does about 0.8 MFLOP: tens of nanoseconds of HBM time.
// The floor is latency: 32 dependent steps, each a 768-wide product, a
// block-wide reduction of A partial sums and an update that the next step
// needs, plus one launch.
//
// What the design does about it: one thread block per batch row, so rows
// run in parallel on separate SMs and nothing crosses blocks.  The block
// stages the weights, biases and all T of its row's contexts in shared
// memory once, before the loop, with every copy in flight at once
// (cp.async), so no step waits on device memory.  The
// sample lives in shared memory for the whole loop.  Each step is two
// __syncthreads: one after the warp-shuffle reduction of the A partial sums,
// one after the A threads that own the state have updated it.  No batch tile
// sizing is carried over from the TPU kernel.
//
// Plain-C interface, loaded with ctypes: ddpm_sampler_launch returns the
// cudaError_t of the launch (0 = success) and does not synchronise.

#include <cuda_bf16.h>
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
