// GroupNorm with image-scope statistics, its affine and the tanh GELU, for
// Hopper (sm_90a): the image tower's norm -> GELU step of every residual
// block, as two kernels, on the layout the caller hands it: NHWC
// (channels_last, C innermost) or NCHW.
//
// Replaces no Pallas kernel: the JAX package computes this GroupNorm and
// GELU with XLA (modules/image_tokenizer.py, group_norm_stats_hwcn).  The
// plain PyTorch version is the chain the port ran before this kernel,
// modules/image_tokenizer.py:PatchGroupNorm.forward followed by
// F.gelu(approximate="tanh"), carried as ops/group_norm.py:
// group_norm_gelu_reference.
//
// Why it was added.  That chain runs as some 15 kernels a residual block,
// each a float32 pass over the block's map: the cast up, two means, x*x,
// the subtraction, the scale, the affine multiply and add, the cast down
// and the GELU.  At octo_base_chunk28 serving 64 robots a block's map is
// (3200, 64, 21, 21), 90.3 M elements: 180.6 MB in bfloat16, 361 MB in
// float32, and the chain moves about 5.8 GB a block, some 5 ms of the
// card's 14 ms image tower a tick at two blocks.
//
// What computes.  x (N, C, H, W), N = E * P: P patches (every frame's) of
// each of E batch elements.  Statistics per (element, group) over the P
// patches, the group's C / G channels and H * W pixels, in float32: mu =
// E[x], var = max(E[x^2] - mu^2, 0) (a NaN stays NaN, as clamp_min leaves
// it), rstd = rsqrt(var + eps).  Then, element by element, in float32 and
// rounded where the plain chain rounds: ((x - mu) * rstd) * weight + bias
// (four correctly rounded operations, no contraction into an FMA), rounded
// to x's dtype; the tanh GELU of that value in float32 (PyTorch's formula,
// 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))), rounded again.  With
// P = 1 the statistics are the 'patch' scope's.  y comes out in x's layout,
// so the convolution after it sees the layout the plain chain gave it.
// Where autograd records (training), the wrapper also asks for each
// element's (mu, var) and its backward, plain PyTorch in
// ops/group_norm.py, starts from them.
//
// What bounds it on the H100.  Its bytes: x read twice (once for the
// statistics, once to normalise) and y written once.  At the shape above,
// 3 x 180.6 = 541.8 MB a block, 0.16 ms at 3.35 TB/s; the statistics pass
// alone 0.054 ms.  The apply pass's arithmetic (some 40 float32
// instructions an element with the tanh) is within a factor of two of its
// byte time, so it is kept to one pass over registers, every constant
// loaded once a thread.
//
// What the design does about it:
// - Two passes, because the statistics of an element span all its patches
//   (2.8 MB in bfloat16 at P = 50) and a block cannot hold them: gn_stats
//   reads x once, gn_apply_gelu reads it again and writes y, nothing in
//   float32 in device memory but a few KB of partial sums.
// - No atomics and no float sum whose order depends on scheduling: each
//   block of gn_stats owns a chunk of one element's rows (pixels in NHWC,
//   (patch, channel) planes in NCHW) and writes its per-group sums to its
//   own slot of a (element, chunk, group, 2) buffer; each block of
//   gn_apply_gelu first sums its element's slots in a fixed order.  Every
//   call, and every replay of a captured graph, gives the same bits.
// - The grid is cut from the shape: about eight blocks an SM
//   (E * chunks near 132 x 8, at most 64 chunks an element, at least four
//   loads a thread), so B = 64 (E = 64, 17 chunks), B = 1 (E = 1, 64
//   chunks) and the 'patch' scope (E = 3200, one chunk) all fill the card.
// - NHWC, the tower's layout: a pixel's C channels are contiguous, so a
//   thread keeps one 16-byte vector of channels (8 in 16-bit, 4 in
//   float32) and walks the pixels of its chunk with 16-byte loads, four in
//   flight; its channels never change, so its sums stay in registers and
//   its weight, bias and statistics are read once.  A block of 256 threads
//   covers 32 pixels of 64 channels a step.
// - NCHW: a warp takes one (patch, channel) plane at a time (its channel
//   fixed) and reads it with its lanes side by side; a plane's 21 x 21
//   elements start at no 16-byte boundary, so this layout, which the tower
//   does not hand it, reads an element a lane.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132 * 8;   // about eight blocks an SM
constexpr int kMaxChunks = 64;           // chunks an element, the soft cap
constexpr int kMinSteps = 4;             // loads a thread, at least
constexpr int kMaxPlanes = 2048;         // NCHW planes a chunk (smem)
constexpr int kMaxGroups = 4096;
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// VEC elements of one load: 16 bytes at most, aligned to their size.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// PyTorch's tanh GELU on an opmath float (GeluCUDAKernelImpl), written the
// same way so that nvcc contracts it the same way.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654;   // sqrt(2) 2/sqrt(pi) / 2
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// The plain chain's rounding points: four float32 operations, each rounded
// (no FMA), the cast to T, the GELU in float32, the cast to T.
template <typename T>
__device__ __forceinline__ T norm_gelu(T v, float mu, float rstd, float w,
                                       float b) {
  const float f = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(to_f(v), mu), rstd), w), b);
  return from_f<T>(gelu_tanh(to_f(from_f<T>(f))));
}

struct Plan {
  int vec;       // elements a load (NHWC); 1 in NCHW
  int threads;
  int rows;      // rows of an element: pixels (NHWC) or planes (NCHW)
  int rpc;       // rows a chunk
  int chunks;    // chunks an element
};

bool make_plan(int n, int c, int h, int w, int groups, int ppe, bool nhwc,
               int elem, Plan* p) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || groups <= 0 || ppe <= 0 ||
      groups > kMaxGroups || c % groups != 0 || n % ppe != 0)
    return false;
  const long e = n / ppe;
  const long hw = long(h) * w;
  long rows, min_rows;
  if (nhwc) {
    int vec = 16 / elem;
    while (vec > 1 && c % vec != 0) vec /= 2;
    const int cv = c / vec;
    if (cv > kThreads) return false;
    const int lanes = kThreads / cv;
    p->vec = vec;
    p->threads = lanes * cv;
    rows = long(ppe) * hw;
    min_rows = long(kMinSteps) * lanes;
  } else {
    p->vec = 1;
    p->threads = kThreads;
    rows = long(ppe) * c;
    min_rows = kThreads / 32;
  }
  if (rows > 2147483647L || long(n) * c * hw > (1L << 40)) return false;
  long chunks = (kTargetBlocks + e - 1) / e;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  const long most = (rows + min_rows - 1) / min_rows;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  long rpc = (rows + chunks - 1) / chunks;
  if (!nhwc && rpc > kMaxPlanes) rpc = kMaxPlanes;
  chunks = (rows + rpc - 1) / rpc;
  if (e * chunks > 2147483647L) return false;
  p->rows = int(rows);
  p->rpc = int(rpc);
  p->chunks = int(chunks);
  return true;
}

// ---- statistics ----------------------------------------------------------

// Block b: element b / chunks, chunk b % chunks.  Thread t keeps channel
// vector t % (C / VEC) and walks pixels t / (C / VEC), + lanes, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    gn_stats_nhwc_kernel(const T* __restrict__ x, float* __restrict__ part,
                         int c, int groups, int rows, int rpc, int chunks) {
  extern __shared__ float red[];   // [lanes][c][2]
  const int blk = blockIdx.x, e = blk / chunks, k = blk % chunks;
  const int cvn = c / VEC, t = threadIdx.x;
  const int cv = t % cvn, lane = t / cvn, lanes = blockDim.x / cvn;
  const int r0 = k * rpc, r1 = min(rows, r0 + rpc);
  const T* src = x + size_t(e) * rows * c + cv * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.0f;
  int r = r0 + lane;
  for (; r + (kUnroll - 1) * lanes < r1; r += kUnroll * lanes) {
    Vec<T, VEC> a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      a[u] = *reinterpret_cast<const Vec<T, VEC>*>(
          src + size_t(r + u * lanes) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(a[u].v[j]);
        s[j] += f;
        q[j] = fmaf(f, f, q[j]);
      }
    }
  }
  for (; r < r1; r += lanes) {
    const Vec<T, VEC> a =
        *reinterpret_cast<const Vec<T, VEC>*>(src + size_t(r) * c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(a.v[j]);
      s[j] += f;
      q[j] = fmaf(f, f, q[j]);
    }
  }
  float* mine = red + (size_t(lane) * c + cv * VEC) * 2;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mine[2 * j] = s[j];
    mine[2 * j + 1] = q[j];
  }
  __syncthreads();
  const int cpg = c / groups;
  float2* out = reinterpret_cast<float2*>(part) + size_t(blk) * groups;
  for (int g = t; g < groups; g += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch)
      for (int l = 0; l < lanes; ++l) {
        a += red[(size_t(l) * c + ch) * 2];
        b += red[(size_t(l) * c + ch) * 2 + 1];
      }
    out[g] = make_float2(a, b);
  }
}

// A warp a (patch, channel) plane; lane 0 of each keeps the plane's sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_nchw_kernel(const T* __restrict__ x, float* __restrict__ part,
                         int c, int groups, int hw, int rows, int rpc,
                         int chunks) {
  extern __shared__ float red[];   // [rpc][2]
  const int blk = blockIdx.x, e = blk / chunks, k = blk % chunks;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int warps = blockDim.x / 32;
  const int r0 = k * rpc, r1 = min(rows, r0 + rpc);
  for (int r = r0 + warp; r < r1; r += warps) {
    const T* p = x + (size_t(e) * rows + r) * hw;
    float s = 0.0f, q = 0.0f;
#pragma unroll 4
    for (int i = lane; i < hw; i += 32) {
      const float f = to_f(p[i]);
      s += f;
      q = fmaf(f, f, q);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, m);
      q += __shfl_xor_sync(0xffffffffu, q, m);
    }
    if (lane == 0) {
      red[2 * (r - r0)] = s;
      red[2 * (r - r0) + 1] = q;
    }
  }
  __syncthreads();
  const int cpg = c / groups;
  float2* out = reinterpret_cast<float2*>(part) + size_t(blk) * groups;
  for (int g = t; g < groups; g += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch) {
      // the chunk's planes of channel ch: r = ch (mod c)
      for (int r = r0 + ((ch - r0 % c) + c) % c; r < r1; r += c) {
        a += red[2 * (r - r0)];
        b += red[2 * (r - r0) + 1];
      }
    }
    out[g] = make_float2(a, b);
  }
}

// ---- normalise, affine, GELU ---------------------------------------------

// The element's statistics from its chunks' sums, in chunk order, into
// gs[g] = (mu, rstd); the element's first block also writes (mu, var)
// where the caller asked for them (stats not null).
__device__ __forceinline__ void group_stats(const float2* __restrict__ part,
                                            int groups, int chunks,
                                            float count, float eps,
                                            float2* gs, float2* stats) {
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.0f, q = 0.0f;
#pragma unroll 4
    for (int k = 0; k < chunks; ++k) {
      const float2 v = part[size_t(k) * groups + g];
      s += v.x;
      q += v.y;
    }
    const float mu = __fdiv_rn(s, count);
    const float d = __fsub_rn(__fdiv_rn(q, count), __fmul_rn(mu, mu));
    const float var = d < 0.0f ? 0.0f : d;   // a NaN stays NaN
    gs[g] = make_float2(mu, rsqrtf(__fadd_rn(var, eps)));
    if (stats != nullptr) stats[g] = make_float2(mu, var);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) gn_apply_gelu_nhwc_kernel(
    const T* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ part,
    T* __restrict__ y, float* __restrict__ stats, int c, int groups,
    int rows, int rpc, int chunks, float count, float eps) {
  extern __shared__ float2 gs[];   // [groups]: mu, rstd
  const int blk = blockIdx.x, e = blk / chunks, k = blk % chunks;
  group_stats(reinterpret_cast<const float2*>(part) +
                  size_t(e) * chunks * groups,
              groups, chunks, count, eps, gs,
              k == 0 && stats != nullptr
                  ? reinterpret_cast<float2*>(stats) + size_t(e) * groups
                  : nullptr);
  __syncthreads();
  const int cvn = c / VEC, t = threadIdx.x;
  const int cv = t % cvn, lane = t / cvn, lanes = blockDim.x / cvn;
  const int cpg = c / groups;
  float mu[VEC], rs[VEC], wv[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int ch = cv * VEC + j;
    const float2 st = gs[ch / cpg];
    mu[j] = st.x;
    rs[j] = st.y;
    wv[j] = weight[ch];
    bv[j] = bias[ch];
  }
  const int r0 = k * rpc, r1 = min(rows, r0 + rpc);
  const size_t base = size_t(e) * rows * c + cv * VEC;
  const T* src = x + base;
  T* dst = y + base;
  int r = r0 + lane;
  for (; r + (kUnroll - 1) * lanes < r1; r += kUnroll * lanes) {
    Vec<T, VEC> a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      a[u] = *reinterpret_cast<const Vec<T, VEC>*>(
          src + size_t(r + u * lanes) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        a[u].v[j] = norm_gelu(a[u].v[j], mu[j], rs[j], wv[j], bv[j]);
      *reinterpret_cast<Vec<T, VEC>*>(dst + size_t(r + u * lanes) * c) =
          a[u];
    }
  }
  for (; r < r1; r += lanes) {
    Vec<T, VEC> a =
        *reinterpret_cast<const Vec<T, VEC>*>(src + size_t(r) * c);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      a.v[j] = norm_gelu(a.v[j], mu[j], rs[j], wv[j], bv[j]);
    *reinterpret_cast<Vec<T, VEC>*>(dst + size_t(r) * c) = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gn_apply_gelu_nchw_kernel(
    const T* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ part,
    T* __restrict__ y, float* __restrict__ stats, int c, int groups, int hw,
    int rows, int rpc, int chunks, float count, float eps) {
  extern __shared__ float2 gs[];   // [groups]: mu, rstd
  const int blk = blockIdx.x, e = blk / chunks, k = blk % chunks;
  group_stats(reinterpret_cast<const float2*>(part) +
                  size_t(e) * chunks * groups,
              groups, chunks, count, eps, gs,
              k == 0 && stats != nullptr
                  ? reinterpret_cast<float2*>(stats) + size_t(e) * groups
                  : nullptr);
  __syncthreads();
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int warps = blockDim.x / 32, cpg = c / groups;
  const int r0 = k * rpc, r1 = min(rows, r0 + rpc);
  for (int r = r0 + warp; r < r1; r += warps) {
    const int ch = r % c;
    const float2 st = gs[ch / cpg];
    const float wv = weight[ch], bv = bias[ch];
    const size_t off = (size_t(e) * rows + r) * hw;
#pragma unroll 4
    for (int i = lane; i < hw; i += 32)
      y[off + i] = norm_gelu(x[off + i], st.x, st.y, wv, bv);
  }
}

// ---- launch --------------------------------------------------------------

struct Args {
  const void* x;
  const float* weight;
  const float* bias;
  void* y;
  float* part;
  float* stats;
  int c, hw, groups;
  float count, eps;
};

template <typename T, int VEC>
int launch_nhwc(const Args& a, const Plan& p, unsigned blocks,
                cudaStream_t s) {
  if constexpr (VEC * sizeof(T) > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int lanes = p.threads / (a.c / VEC);
    const size_t smem_stats = size_t(lanes) * a.c * 2 * sizeof(float);
    const size_t smem_apply = size_t(a.groups) * sizeof(float2);
    if (smem_stats > 48 * 1024 || smem_apply > 48 * 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    gn_stats_nhwc_kernel<T, VEC><<<blocks, p.threads, smem_stats, s>>>(
        static_cast<const T*>(a.x), a.part, a.c, a.groups, p.rows, p.rpc,
        p.chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gn_apply_gelu_nhwc_kernel<T, VEC><<<blocks, p.threads, smem_apply, s>>>(
        static_cast<const T*>(a.x), a.weight, a.bias, a.part,
        static_cast<T*>(a.y), a.stats, a.c, a.groups, p.rows, p.rpc,
        p.chunks, a.count, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_nchw(const Args& a, const Plan& p, unsigned blocks,
                cudaStream_t s) {
  const size_t smem_stats = size_t(p.rpc) * 2 * sizeof(float);
  const size_t smem_apply = size_t(a.groups) * sizeof(float2);
  if (smem_stats > 48 * 1024 || smem_apply > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  gn_stats_nchw_kernel<T><<<blocks, p.threads, smem_stats, s>>>(
      static_cast<const T*>(a.x), a.part, a.c, a.groups, a.hw, p.rows, p.rpc,
      p.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_apply_gelu_nchw_kernel<T><<<blocks, p.threads, smem_apply, s>>>(
      static_cast<const T*>(a.x), a.weight, a.bias, a.part,
      static_cast<T*>(a.y), a.stats, a.c, a.groups, a.hw, p.rows, p.rpc,
      p.chunks, a.count, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, const Plan& p, unsigned blocks, bool nhwc,
           cudaStream_t s) {
  if (!nhwc) return launch_nchw<T>(a, p, blocks, s);
  switch (p.vec) {
    case 1:
      return launch_nhwc<T, 1>(a, p, blocks, s);
    case 2:
      return launch_nhwc<T, 2>(a, p, blocks, s);
    case 4:
      return launch_nhwc<T, 4>(a, p, blocks, s);
    case 8:
      return launch_nhwc<T, 8>(a, p, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int elem_size(int dtype) {
  return dtype == 0 ? 4 : (dtype == 1 || dtype == 2) ? 2 : 0;
}

}  // namespace

extern "C" {

// The cut of a launch on x (n, c, h, w) with `groups` groups and `ppe`
// patches an element, NHWC where nhwc is 1, in the dtype (0 float32, 1
// bfloat16, 2 float16), into out[0 .. 4]: elements a load, threads a block,
// rows an element, rows a chunk, chunks an element.  The partial sums take
// (n / ppe) * chunks * groups * 2 floats.  Returns 0, or
// cudaErrorInvalidValue where the shape is refused.
int gn_plan(int n, int c, int h, int w, int groups, int ppe, int nhwc,
            int dtype, long long* out) {
  Plan p;
  const int elem = elem_size(dtype);
  if (elem == 0 || !make_plan(n, c, h, w, groups, ppe, nhwc != 0, elem, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.vec;
  out[1] = p.threads;
  out[2] = p.rows;
  out[3] = p.rpc;
  out[4] = p.chunks;
  return 0;
}

// y = gelu_tanh(groupnorm(x) * weight + bias) as the header says: x and y
// (n, c, h, w) in the dtype, dense NCHW or, where nhwc is 1, NHWC; weight
// and bias (c,) float32; part the partial sums gn_plan sizes; stats null,
// or (n / ppe, groups, 2) float32, written with each (mu, var): the
// training route keeps them for its backward.  x, y 16-byte
// aligned.  Returns the cudaError_t of the launches (0 on success); never
// synchronises.
int gn_launch(const void* x, const void* weight, const void* bias, void* y,
              void* part, void* stats, int n, int c, int h, int w, int groups,
              int ppe, float eps, int nhwc, int dtype, void* stream) {
  Plan p;
  const int elem = elem_size(dtype);
  if (elem == 0 || !make_plan(n, c, h, w, groups, ppe, nhwc != 0, elem, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Args a{x,
         static_cast<const float*>(weight),
         static_cast<const float*>(bias),
         y,
         static_cast<float*>(part),
         static_cast<float*>(stats),
         c,
         h * w,
         groups,
         float(double(ppe) * (c / groups) * h * w),
         eps};
  const unsigned blocks = unsigned(long(n / ppe) * p.chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, p, blocks, nhwc != 0, s);
    case 1:
      return launch<__nv_bfloat16>(a, p, blocks, nhwc != 0, s);
    case 2:
      return launch<__half>(a, p, blocks, nhwc != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
