// The grouped expert products of a dropless routed layer and the combine of
// each token's rows, for Hopper (sm_90a): ops/grouped_experts.py's
// grouped_experts, three kernels on one stream.
//
// Replaces no Pallas kernel: the JAX package's only expert layer is the
// GShard block (modules/moe.py), one-hot dispatch and combine einsums over a
// capacity that drops tokens.  A DeepSeek-V3-style layer computes every one
// of a token's k choices, so each expert sees however many rows its routing
// gives it.  The plain version is ops/grouped_experts.py:
// grouped_experts_reference (each expert's group through float32 PyTorch
// products, the same rounding points).
//
// What computes.  The wrapper sorts the (token, choice) pairs by expert on
// the device and cuts each expert's rows into tiles of kBM rows
// (tile_expert[i], tile_row[i]; expert E past the last tile).  Then:
// - expert_gate_up_kernel: for a tile and 64 features, gathers the tokens'
//   rows of x (T, H) and multiplies them by the expert's 64 gate and 64 up
//   rows of w_gate_up (E, 2F, H) (gate rows first), float32 sums, and
//   writes silu(gate) * up rounded to bf16 into hid (N, F), N = T k pairs
//   in sorted order;
// - expert_down_kernel: for a tile and 128 output columns, multiplies hid's
//   rows by the expert's rows of w_down (E, H, F), float32 sums, scales
//   each row by its routing weight and writes it rounded to bf16 into
//   y (N, H);
// - expert_combine_kernel: out[t] = shared[t] + the token's k rows of y,
//   summed in float32 in the order of its choices and rounded once.  No
//   atomics anywhere: every call, and every replay of a captured graph,
//   gives the same bits.
//
// What bounds it on the H100.  At the benchmark's B=8 tick each expert sees
// some 70-170 rows a layer while its weights are 17.3 MB (1.1 GB a layer):
// a few FLOPs a byte, so the products are bound by reading the weights
// (0.33 ms a layer at 1792 tokens at 3.35 TB/s).  A padded tile costs
// tensor-core time and no bytes.
//
// What the design does about it:
// - Both operands K-major, as they lie in memory: x / hid rows and the
//   expert's weight rows, each a product C = A B^T of two row tiles.  A
//   block is two warpgroups on a 128-row tile and 128 weight rows, each
//   warpgroup 64 of the rows: wgmma m64n128k16, float32 accumulators in
//   registers, A (the rows) from each warp's ldmatrix fragments, B (the
//   weights, one tile for both warpgroups) by a descriptor on a tile in
//   wgmma's 128-byte swizzle (flash_common.cuh's helpers, as
//   flash_attention_wide.cu takes K).
// - 128 rows a tile, so that a weight tile goes through L2 and shared
//   memory once for every 128 of its expert's rows: at 64 rows the
//   products read L2 three times over at 1792 tokens and were bound there
//   (gate_up 0.48 ms on the H100); the padded rows cost tensor-core time,
//   which wgmma has to spare at these sizes.
// - Stages of 64 deep come through a ring of three cp.async stages (34 KB
//   each, two blocks an SM), so two stages a block, some 136 KB an SM, are
//   in flight.  The gather of x rows rides in the copies: each thread
//   copies the same four rows at every stage.  Each thread fences its
//   copies to the async proxy before the barrier that hands a stage to
//   wgmma.
// - The row tiles of an expert are neighbours in blockIdx.x, so the blocks
//   that read one weight tile run together and its second read is an L2
//   hit; the grid holds the most tiles any routing can need and a block
//   past the last exits at once, so no count comes back to the host.
// - The SwiGLU and the routing weight are applied to the accumulators; the
//   intermediate of width F is written once in bf16.

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // two warpgroups, 64 rows each
constexpr int kBM = 128;             // pair rows a tile (ops/grouped_experts.py)
constexpr int kBN = 128;             // weight rows a block
constexpr int kBK = 64;              // depth a stage: one swizzle atom's row
constexpr int kLDA = kBK + 8;        // A's shared row stride: the 8 rows of an
                                     // ldmatrix fall in distinct banks
constexpr int kStages = 3;
constexpr int kTileB = kBN * kBK;    // swizzled, 16 KB: first in a stage
constexpr int kStageElems = kTileB + kBM * kLDA;   // 34 KB, 34 x 1024
constexpr size_t kSmem = 1024 + size_t(kStages) * kStageElems * sizeof(bf16);
constexpr int kGluFeatures = kBN / 2;   // gate_up: 64 gate + 64 up rows
constexpr int kCombineThreads = 256;
static_assert(kStageElems * sizeof(bf16) % 1024 == 0,
              "every stage's B tile on a swizzle atom");

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[j] = A B^T over depth `depth` for the warpgroup's 64 rows (warp w's
// 16 rows, m16n8 accumulator layout) and 128 weight rows (n8 tiles j).
// Thread tid copies, at every stage, chunk tid % 8 of A rows tid / 8 + 32 i
// (a_src[i], zeros where !a_live[i]) and of B rows tid / 8 + 32 i
// (b_src[i]).
__device__ __forceinline__ void tile_product(float (&acc)[16][4], bf16* smem,
                                             const bf16* const (&a_src)[4],
                                             const bool (&a_live)[4],
                                             const bf16* const (&b_src)[4],
                                             int depth) {
  const int tid = threadIdx.x, c = tid & 7, r0 = tid >> 3;
  const int warp = tid >> 5, lane = tid & 31;   // warp 4 wg + w: rows 16 warp
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int steps = depth / kBK;

  auto load = [&](int stage, int kt) {
    bf16* sb = smem + stage * kStageElems;
    bf16* sa = sb + kTileB;
    const int k0 = kt * kBK + c * 8;
    // B row r's 16-byte chunk c at chunk c ^ (r & 7): the 128-byte swizzle
    const int swz = ((c ^ r0) & 7) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp_async16(sb + (r0 + 32 * i) * kBK + swz, b_src[i] + k0, true);
      cp_async16(sa + (r0 + 32 * i) * kLDA + c * 8, a_src[i] + k0,
                 a_live[i]);
    }
  };

#pragma unroll
  for (int j = 0; j < 16; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();
    // this thread's copies of stage kt seen by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    const bf16* sb = smem + (kt % kStages) * kStageElems;
    const bf16* sa = sb + kTileB + warp * 16 * kLDA;
    uint32_t af[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      ldsm_x4(af[kk], sa + (l8 * 8 + lr) * kLDA + kk * 16 + l16 * 8);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // K-major: 32 bytes into the atom
      wgmma_n128<0>(acc, af[kk], sw128_desc(sb + kk * 16, 16, 1024), sb);
    wgmma_commit_wait();
  }
  cp_async_wait<0>();
}

// The block's shared memory, aligned to the swizzle's 1024-byte atoms.
__device__ __forceinline__ bf16* aligned_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Grid (tiles, F / 64).
__global__ void __launch_bounds__(kThreads, 2)
    expert_gate_up_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w_gate_up,
                          bf16* __restrict__ hid,
                          const int* __restrict__ tokens,
                          const int* __restrict__ tile_expert,
                          const int* __restrict__ tile_row,
                          const int* __restrict__ offsets, int experts,
                          int h, int f) {
  const int e = tile_expert[blockIdx.x];
  if (e >= experts) return;
  const int row0 = tile_row[blockIdx.x], row_end = offsets[e + 1];
  const int f0 = blockIdx.y * kGluFeatures, r0 = threadIdx.x >> 3;
  const bf16* a_src[4];
  bool a_live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + r0 + 32 * i;
    a_live[i] = row < row_end;
    a_src[i] = x + size_t(tokens[a_live[i] ? row : row0]) * h;
  }
  const bf16* we = w_gate_up + size_t(e) * 2 * f * h;
  const bf16* b_src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 32 * i;
    b_src[i] = we + size_t(r < kGluFeatures ? f0 + r
                                            : f + f0 + r - kGluFeatures) * h;
  }
  float acc[16][4];
  tile_product(acc, aligned_smem(), a_src, a_live, b_src, h);

  // n8 tiles 0-7 the gate rows, 8-15 the up rows of the same features
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + half * 8 + g;
    if (row >= row_end) continue;
    bf16* dst = hid + size_t(row) * f + f0 + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* gate = &acc[j][2 * half];
      const float* up = &acc[j + 8][2 * half];
      store2<bf16, bf16>(dst + j * 8, silu(gate[0]) * up[0],
                         silu(gate[1]) * up[1]);
    }
  }
}

// Grid (tiles, H / 128).
__global__ void __launch_bounds__(kThreads, 2)
    expert_down_kernel(const bf16* __restrict__ hid,
                       const bf16* __restrict__ w_down, bf16* __restrict__ y,
                       const float* __restrict__ weight,
                       const int* __restrict__ tile_expert,
                       const int* __restrict__ tile_row,
                       const int* __restrict__ offsets, int experts, int h,
                       int f) {
  const int e = tile_expert[blockIdx.x];
  if (e >= experts) return;
  const int row0 = tile_row[blockIdx.x], row_end = offsets[e + 1];
  const int c0 = blockIdx.y * kBN, r0 = threadIdx.x >> 3;
  const bf16* a_src[4];
  bool a_live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + r0 + 32 * i;
    a_live[i] = row < row_end;
    a_src[i] = hid + size_t(a_live[i] ? row : row0) * f;
  }
  const bf16* we = w_down + size_t(e) * h * f;
  const bf16* b_src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b_src[i] = we + size_t(c0 + r0 + 32 * i) * f;
  float acc[16][4];
  tile_product(acc, aligned_smem(), a_src, a_live, b_src, f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + half * 8 + g;
    if (row >= row_end) continue;
    const float wt = weight[row];
    bf16* dst = y + size_t(row) * h + c0 + 2 * q;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store2<bf16, bf16>(dst + j * 8, acc[j][2 * half] * wt,
                         acc[j][2 * half + 1] * wt);
  }
}

// Grid (T): a block a token, 8 columns a thread a step (16-byte loads).
__global__ void __launch_bounds__(kCombineThreads)
    expert_combine_kernel(const bf16* __restrict__ y,
                          const int* __restrict__ inverse,
                          const bf16* __restrict__ shared,
                          bf16* __restrict__ out, int h, int k) {
  const size_t t = blockIdx.x;
  for (int c = threadIdx.x * 8; c < h; c += kCombineThreads * 8) {
    float acc[8];
    const uint4 s = *reinterpret_cast<const uint4*>(shared + t * h + c);
    const bf16* sv = reinterpret_cast<const bf16*>(&s);
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] = __bfloat162float(sv[v]);
    for (int i = 0; i < k; ++i) {
      const size_t r = inverse[t * k + i];
      const uint4 u = *reinterpret_cast<const uint4*>(y + r * h + c);
      const bf16* uv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v] += __bfloat162float(uv[v]);
    }
    uint4 o;
    uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int v = 0; v < 4; ++v) ov[v] = pack2<bf16>(acc[2 * v], acc[2 * v + 1]);
    *reinterpret_cast<uint4*>(out + t * h + c) = o;
  }
}

}  // namespace

extern "C" {

// Lets both product kernels take their 103 KB of shared memory; call once
// before the first launch (and before any graph capture).  Returns the
// cudaError_t.
int ge_prepare() {
  int err = launch_config(expert_gate_up_kernel, kSmem);
  if (err) return err;
  return launch_config(expert_down_kernel, kSmem);
}

// out (T, H) = shared + sum over each token's k choices of weight *
// down_e(silu(gate_e x) * up_e x), as the header says.  x, shared, out
// (T, H), w_gate_up (E, 2F, H), w_down (E, H, F), hid (N, F) and y (N, H)
// scratch, N = T k, all bf16, dense and 16-byte aligned; tokens (N) and
// inverse (N) int32, the sorted layout; weight (N) float32 in sorted order;
// offsets (E + 1) int32; tile_expert, tile_row (tiles) int32, the tile
// plan.  H a multiple of 128, F of 64.  Returns the cudaError_t of the
// launches (0 on success); never synchronises.
int ge_launch(const void* x, const void* w_gate_up, const void* w_down,
              const void* shared, void* hid, void* y, void* out,
              const void* tokens, const void* inverse, const void* weight,
              const void* offsets, const void* tile_expert,
              const void* tile_row, int t, int k, int experts, int h, int f,
              int tiles, void* stream) {
  if (t < 1 || k < 1 || experts < 1 || tiles < 1 || h % kBN ||
      f % kGluFeatures)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(w_gate_up) || !aligned16(w_down) ||
      !aligned16(shared) || !aligned16(hid) || !aligned16(y) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  const int* tr = static_cast<const int*>(tile_row);
  const int* off = static_cast<const int*>(offsets);
  expert_gate_up_kernel<<<dim3(tiles, f / kGluFeatures), kThreads, kSmem,
                          s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_gate_up),
      static_cast<bf16*>(hid), static_cast<const int*>(tokens), te, tr, off,
      experts, h, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expert_down_kernel<<<dim3(tiles, h / kBN), kThreads, kSmem, s>>>(
      static_cast<const bf16*>(hid), static_cast<const bf16*>(w_down),
      static_cast<bf16*>(y), static_cast<const float*>(weight), te, tr, off,
      experts, h, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expert_combine_kernel<<<t, kCombineThreads, 0, s>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(inverse),
      static_cast<const bf16*>(shared), static_cast<bf16*>(out), h, k);
  return static_cast<int>(cudaGetLastError());
}

const char* ge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
