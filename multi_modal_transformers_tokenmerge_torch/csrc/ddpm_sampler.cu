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
// needs, plus one launch.  The first design took 2.4 us a step, the same at
// any batch (a row is a block): two barriers a step, A x 5 shuffles, a
// serial sum of the warps' partials by A threads, the step's coefficients
// and noise loaded from device memory inside the loop, and the weights
// re-read from shared memory as 2-byte loads every step.
//
// What the design does about it: one thread block per batch row, so rows
// run in parallel on separate SMs and nothing crosses blocks.  Each of the
// 256 threads owns H / 256 hidden units and holds their Wn rows, Wo columns
// and biases in registers for the whole loop, in float32.  The block
// stages all T of its row's contexts, the coefficients and its noise in
// shared memory once, before the loop, every copy in flight at once
// (cp.async), so nothing in the loop touches device memory; a thread reads
// step t + 1's context elements and step t's coefficients and noise while
// it computes step t.  A step is one __syncthreads: each warp folds its A
// partial sums with a transpose reduction (9 shuffles at A = 8: lane l ends
// with the sum of action l / 4) and writes them to a buffer
// double-buffered by t & 1; after the barrier lane a of every warp sums the
// warps' partials of action a, updates that value of the sample and rounds
// it, and A shuffles hand the rounded sample to the whole warp for the next
// product - no round trip through shared memory, no second barrier.  On
// this card the update is worth keeping to one action a lane: with every
// thread summing and updating all A values (A times the sums and the
// roundings) the kernel took 37.6 us against 28.9 (pool_sampler_probe.py).
// 256 threads beat 128 and 768; 384 ran 6% faster, but their order of the
// sums rounded one float16 DDIM check of chip_smoke.py 2.5 eps from the
// plain version, past its gate of 2.
// Action dims below 8 (16) run padded with zero weights, which keep the
// padding at zero.  The batch is not blocked: one block a row.  This kernel
// takes A <= 16, H <= ddpm_sampler_max_hidden(A) and T x H contexts that fit
// one block's shared memory; every other shape runs the wide kernel
// (ddpm_sampler_wide.cu), which blocks the batch and streams the contexts.
//
// Plain-C interface, loaded with ctypes: ddpm_sampler_launch returns the
// cudaError_t of the launch (0 = success) and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // threads of a block at most
// hidden units a thread holds at most, at an action width padded to 8:
// H <= kBlock * kUnitsMax; half as many at 16, to stay in registers
constexpr int kUnitsMax = kBlock >= 256 ? 1536 / kBlock : 6;
__host__ __device__ constexpr int units_max(int ma) {
  return ma == 8 ? kUnitsMax : (kUnitsMax > 1 ? kUnitsMax / 2 : 1);
}
constexpr int kMaxWarps = kBlock / 32;
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

// the padded action width: 8, or 16 above 8
__host__ __device__ __forceinline__ int padded_a(int adim) {
  return adim <= 8 ? 8 : kMaxA;
}

// shared memory: ctx (T*H) in T; coefficients (T*4), noise (T*MA) and the
// partial sums (2*kMaxWarps*MA) in float32
__host__ __device__ __forceinline__ size_t smem_bytes(int steps, int hidden,
                                                      int adim, int elem) {
  const int ma = padded_a(adim);
  return align16(size_t(steps) * hidden * elem) +
         sizeof(float) * (size_t(steps) * (4 + ma) + 2 * kMaxWarps * ma);
}

// Copy `rows` rows of `row_elems` elements from global memory (rows
// `src_stride` elements apart) to shared memory rows `dst_stride` apart.
// Rows of whole 16-byte chunks go through cp.async, all in flight at once;
// otherwise element by element.  The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, size_t dst_stride,
                                           const T* src, int rows,
                                           int row_elems, size_t src_stride,
                                           int tid, int nthreads) {
  const size_t row_bytes = size_t(row_elems) * sizeof(T);
  const bool vec = row_bytes % 16 == 0 &&
                   (src_stride * sizeof(T)) % 16 == 0 &&
                   (dst_stride * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int per_row = int(row_bytes / 16);
    for (int c = tid; c < rows * per_row; c += nthreads) {
      const int r = c / per_row;
      const int k = c - r * per_row;
      __pipeline_memcpy_async(
          reinterpret_cast<char*>(dst + r * dst_stride) + size_t(k) * 16,
          reinterpret_cast<const char*>(src + r * src_stride) +
              size_t(k) * 16,
          16);
    }
  } else {
    for (int i = tid; i < rows * row_elems; i += nthreads) {
      const int r = i / row_elems;
      const int k = i - r * row_elems;
      dst[r * dst_stride + k] = src[r * src_stride + k];
    }
  }
}

// The warp's sums of v[0 .. MA-1] over its 32 lanes, transposed: each round
// halves the values a lane holds, lanes whose `off` bit is set keeping the
// upper half, until one is left; the last rounds add it across the lanes
// that share it.  Lane l returns the sum of v[l / (32 / MA)].
template <int MA>
__device__ __forceinline__ float transpose_reduce(float (&v)[MA], int lane) {
#pragma unroll
  for (int n = MA, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (int off = 16 / MA; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// v of lanes 0 .. MA-1 into out[0 .. MA-1], in every lane
template <int MA>
__device__ __forceinline__ void spread(float (&out)[MA], float v) {
#pragma unroll
  for (int a = 0; a < MA; ++a) out[a] = __shfl_sync(0xffffffffu, v, a);
}

template <typename T, int MODE, int MA>
__global__ void __launch_bounds__(kBlock)
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
  T* ctx_s = reinterpret_cast<T*>(smem);
  float* coef_s = reinterpret_cast<float*>(
      smem + align16(size_t(steps) * hidden * sizeof(T)));   // [T][ncoef]
  float* noise_s = coef_s + size_t(steps) * 4;              // [T][MA]
  float* part_s = noise_s + size_t(steps) * MA;   // [2][kMaxWarps][MA]

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  constexpr int ncoef = MODE == kDDPM ? 3 : 4;

  // everything the loop reads from device memory, in flight at once
  stage_rows(ctx_s, hidden, ctx + size_t(b) * hidden, steps, hidden,
             size_t(batch) * hidden, tid, nthreads);
  stage_rows(coef_s, 0, coeffs, 1, steps * ncoef, 0, tid, nthreads);
  if (MODE == kDDPM) {
    stage_rows(noise_s, MA, noise + size_t(b) * adim, steps, adim,
               size_t(batch) * adim, tid, nthreads);
    for (int i = tid; i < steps * (MA - adim); i += nthreads)
      noise_s[(i / (MA - adim)) * MA + adim + i % (MA - adim)] = 0.f;
  }
  __pipeline_commit();

  // the thread's hidden units j = tid + u * nthreads, u < units, with their
  // weights in registers (zero past adim)
  constexpr int UM = units_max(MA);
  const int units = tid < hidden ? (hidden - 1 - tid) / nthreads + 1 : 0;
  float wn_r[UM][MA], wo_r[UM][MA], bn_r[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    const int j = tid + u * nthreads;
    const bool on = u < units;
    bn_r[u] = on ? Cvt<T>::to_f(bn[j]) : 0.f;
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      wn_r[u][a] = on && a < adim ? Cvt<T>::to_f(wn[size_t(j) * adim + a])
                                  : 0.f;
      wo_r[u][a] = on && a < adim ? Cvt<T>::to_f(wo[size_t(a) * hidden + j])
                                  : 0.f;
    }
  }
  // lane am of every warp keeps action am of the sample (32 / MA copies a
  // warp) and spreads its rounding to the warp with MA shuffles
  const int am = lane & (MA - 1);
  float x = am < adim ? noisy[size_t(b) * adim + am] : 0.f;
  const float bo_a = am < adim ? Cvt<T>::to_f(bo[am]) : 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();

  float cur[UM], xr[MA];
#pragma unroll
  for (int u = 0; u < UM; ++u)
    cur[u] = u < units ? Cvt<T>::to_f(ctx_s[tid + u * nthreads]) : 0.f;
  spread<MA>(xr, rnd<T>(x));

  for (int t = 0; t < steps; ++t) {
    // step t + 1's contexts, read while this step computes
    float nxt[UM];
    const T* ctx_n = ctx_s + size_t(t + 1 < steps ? t + 1 : t) * hidden;
#pragma unroll
    for (int u = 0; u < UM; ++u)
      nxt[u] = u < units ? Cvt<T>::to_f(ctx_n[tid + u * nthreads]) : 0.f;
    // and this step's coefficients and noise, which the update after the
    // barrier needs
    const float* c = coef_s + t * ncoef;
    const float c0 = c[0], c1 = c[1], c2 = c[2];
    const float c3 = MODE == kDDPM ? 0.f : c[ncoef - 1];
    const float nz = MODE == kDDPM ? noise_s[t * MA + am] : 0.f;

    float part[MA];
#pragma unroll
    for (int a = 0; a < MA; ++a) part[a] = 0.f;
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      if (u < units) {
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < MA; ++a) acc = fmaf(xr[a], wn_r[u][a], acc);
        float h = rnd<T>(rnd<T>(acc) + bn_r[u]);
        h = fmaxf(rnd<T>(h + cur[u]), 0.f);
#pragma unroll
        for (int a = 0; a < MA; ++a) part[a] = fmaf(h, wo_r[u][a], part[a]);
      }
    }

    const float sum = transpose_reduce<MA>(part, lane);
    float* buf = part_s + (t & 1) * kMaxWarps * MA;
    if ((lane & (32 / MA - 1)) == 0) buf[warp * MA + lane / (32 / MA)] = sum;
    __syncthreads();

    float e = 0.f;
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
#pragma unroll
    for (int u = 0; u < UM; ++u) cur[u] = nxt[u];
  }

  if (tid < adim) out[size_t(b) * adim + tid] = x;
}

template <typename T, int MODE>
cudaError_t launch_typed(const void* noisy, const void* ctx, const void* noise,
                         const void* coeffs, const void* wn, const void* bn,
                         const void* wo, const void* bo, void* out, int steps,
                         int batch, int hidden, int adim, float clip_value,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(steps, hidden, adim, sizeof(T));
  auto kernel = adim <= 8 ? ddpm_sampler_kernel<T, MODE, 8>
                          : ddpm_sampler_kernel<T, MODE, kMaxA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int threads = hidden < kBlock ? (hidden + 31) / 32 * 32 : kBlock;
  kernel<<<batch, threads, smem, stream>>>(
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

// the widest hidden layer the kernel holds in registers at this action dim
int ddpm_sampler_max_hidden(int adim) {
  return kBlock * units_max(padded_a(adim));
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  mode: 0 DDPM, 1 DDIM raw eps,
// 2 DDIM recomputed eps.  Returns a cudaError_t.
int ddpm_sampler_launch(const void* noisy, const void* ctx, const void* noise,
                        const void* coeffs, const void* wn, const void* bn,
                        const void* wo, const void* bo, void* out, int steps,
                        int batch, int hidden, int adim, float clip_value,
                        int dtype, int mode, void* stream) {
  if (adim < 1 || adim > kMaxA || steps < 1 || batch < 1 || hidden < 1 ||
      hidden > ddpm_sampler_max_hidden(adim))
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
