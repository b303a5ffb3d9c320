// Backward of a stride-1 VALID max-pool on NCHW planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pool_bwd_kernel of the JAX package's
// ops/pool.py:65 (called through _pool_bwd_pallas, :97).  The plain PyTorch
// version is ops/pool.py:pool_bwd_reference.
//
// What it computes.  For x (N, C, H, W) and the output cotangent g (N, C,
// OH, OW), each window's gradient goes to the FIRST position in raster
// order whose float32 value equals the window's float32 max (XLA's
// select_and_scatter tie rule); a window holding a NaN routes nowhere.
// dx accumulates in x's dtype, one window slot (di, dj) after another in
// raster order, as the JAX kernel adds its nine shifted slices.
//
// What bounds it on the H100.  Nothing but its bytes: x and g are read
// once and dx written once (about 307 MB in bfloat16 at octo_base training,
// B=32: N=1600 patches, C=64, 23x23 in, 21x21 out - 0.092 ms at 3.35 TB/s),
// against some 20 compares and adds per element.  The design answers
// with a gather instead of the TPU's scatter: a block stages whole planes
// of x and g in shared memory (the 23x23 plane is 2 KB in float32), finds
// every window's winning slot once, then every input element collects the
// gradients of the windows it won, in slot order - no atomics, no
// read-modify-write of dx in device memory, deterministic.  Each element
// of x, g and dx crosses device memory once, coalesced.

#include <cuda_bf16.h>
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
