// Block-sparse masked flash attention at head dims above 256 for Hopper
// (sm_90a): the plain forward, the forward that saves the row logsumexp,
// and the dq and dk/dv backward passes, for any head dim D that is a
// multiple of 64 (the wrapper zero-pads any other D above 256 to the next
// multiple of 64 and passes 1/sqrt(D) of the true D as the scale).
//
// Replaces, at those head dims, the Pallas TPU kernels of the JAX package's
// ops/flash_attention.py: _flash_kernel (:60), _flash_fwd_lse_kernel (:328),
// _flash_dq_kernel (:383) and _flash_dkv_kernel (:430), which take any D.
// flash_attention.cu holds the kernels for D up to 256; this file computes
// the same function (its source note: the mask and skip tables, the logits'
// scale and -1e30 mask, the online softmax clamped at -5e29, the casts
// before each product, zeros for dead rows, the Philox dropout counter
// with its b0 and h0 offsets, float32 outputs for the ring).  The plain
// PyTorch versions that compute it the way these kernels do are
// ops/flash_attention.py: flash_*_wide_reference.
//
// Why a second family.  The kernels of flash_attention.cu hold a block's
// whole Q (or K) rows and its output accumulator, D columns wide, in
// registers and shared memory.  At D = 512 a 64-row float32 output tile is
// 128 KB, more than a block's registers, and one 64 x 512 tile each of Q, K
// and V in bf16 is 192 KB of shared memory.  So the outputs over D (O, dQ,
// dK and dV) are cut into slices of DV = 128 columns, each owned by one
// block: the grid is (row tiles x slices, heads, batch), the slices of one
// row tile adjacent.  The sums over all of D (the logits S = Q K^T, and
// dP = dO V^T in the backward) are what the two designs here get
// differently.
//
// The 16-bit kernels up to D = 1024 (CLUSTER): the slice blocks of a row
// tile (a query tile in the forwards and dq, a key tile in dk/dv) are one
// thread block cluster that computes the sums over D once, each block its
// slice's partial products, the partials exchanged through distributed
// shared memory (the cluster forward's and the cluster backward's notes,
// below).  Above 1024, more slices than a portable cluster holds, they keep
// the chunked body (fwd_plan and bwd_plan, which ops/flash_attention.py
// mirrors).  What bounds them on this card is neither the tensor cores nor
// device memory but moving operands and partials, and waiting on them
// (octo_deep_h512's first stage at B = 32, 3 heads of 512, one H100 at 700
// W; flash_wide_probe.py times each step):
//   * the forwards: about 11 GFLOP over the live tiles (some 0.01 ms) and
//     88 MB (0.026 ms).  The chunked body recomputes S in every slice
//     block, restaging Q and K from L2 for every key tile and slice (some
//     800 MB through L2) behind a block barrier every 64 columns, and reads
//     0.26 ms; the cluster body moves some 220 MB, keeps Q in registers,
//     brings K and V by TMA and runs both products on wgmma: 0.12 ms;
//   * dq and dk/dv: 110 and 132 MB (0.033 and 0.040 ms).  The chunked
//     bodies compute S and dP in every slice block (at D = 512 nine
//     products' worth of tensor-core work where dq needs three, ten where
//     dk/dv needs four) and restage the operands from L2 on every step (some
//     1.5 GB through L2 a kernel): 0.40 and 0.55 ms.  The cluster bodies
//     compute each sum once, keep the row tile's own operands in registers
//     and stream only their slices of the other two: 0.19 and 0.23 ms.
//     What is left is the exchange: per 64 x 64 tile a block stores 24 KB
//     of float32 partials into its peers (at 4 slices) and takes in as
//     many, and one block an SM (its accumulators fill the registers) waits
//     on them; `flash_wide_probe.py phases` reads where a block's time goes.
//
// The chunked body (above D = 1024):
//   * The reductions over D go in chunks of DC = 64 columns (32 in dq:
//     with its four operands' chunks in the ring that halves its shared
//     memory, two blocks an SM in place of one, 30-52% less time at
//     octo_deep_h512's stages, while 32 costs the forward and dk/dv 2-21%:
//     flash_wide_probe.py): the chunks stream through a two-stage cp.async
//     ring, one barrier a chunk, and S (dP) accumulates in registers across
//     the chunks, in chunk order.
//   * Every slice block recomputes the same S (and P, dP, dS) in the same
//     order, bitwise equal across the slices, so the slice blocks agree on
//     the softmax; slice 0 stores the LSE.  The slice's own columns of V
//     (forward), K (dq) or Q and dO (dk/dv) arrive with the first chunk of
//     a tile, in their own buffers of the ring.
//   * The cost is the recomputed S: at D = 512 the forward runs the Q K^T
//     product 4 times for one P V, about 2.5 times the least tensor-core
//     work.  dk/dv holds two accumulators (dK and dV), so its slice of 128
//     columns is split between two warps a row group of 16 keys (kDkvDS):
//     each computes S^T and dP^T for half the q tile's queries and passes
//     P^T and dS^T, rounded to T, through shared memory to its partner (as
//     flash_attention.cu's dk/dv does at D = 128 and 256), so S^T and dP^T
//     are recomputed 4 times at D = 512, not 8 as with one warp a row group
//     and 64-column slices, the first design: 2.2-2.5 times less time at
//     octo_deep_h512's stages and D = 768 (flash_wide_probe.py).
//   * Its 16-bit kernels run every product on the tensor cores, as
//     flash_attention.cu does (mma.sync m16n8k16, float32 accumulators,
//     ldmatrix operands, p and dS rounded to T into the A operand, the
//     exponent on ex2.approx, dropout words shared between lanes by
//     shuffles): a block is four warps of 16 rows of its own axis (queries
//     for the forward and dq, keys for dk/dv; eight warps for dk/dv) over
//     64 rows of the other, the mask table's tile, whose skip tables
//     (64 x 64) it walks.  Shared memory: forward 81,920 bytes (Q and K
//     chunk rings, the V slice and mask rings), dq 86,016, dk/dv 173,056
//     (with P^T and dS^T).
// The float32 kernels (the card-against-CPU checks and the tests only) are
// CUDA-core bodies with the same chunks and slices (DV = 64), 256 threads,
// operands staged as float32 without a ring: simple and right, not fast.
// The last slice is 64 columns wide when D is an odd multiple of 64 (D =
// 320, 576); its products past the slice are skipped by a test on a value
// every thread of the block (in dk/dv: of the warp) shares.

#include <cuda.h>

#include <initializer_list>

#include "cluster.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kBM = 64;   // rows of a block's own axis (the table's tile)
constexpr int kBN = 64;   // rows of the other axis a step (the table's tile)
constexpr int kDC = 64;   // columns of a reduction chunk (forward, dk/dv)
constexpr int kDqDC = 32;  // ... of dq's (flash_wide_probe.py)
constexpr int kFwdDV = 128;  // output columns of a forward or dq slice
constexpr int kDkvDS = 2;    // warps sharing a dk/dv row group (DkvShape)
constexpr int kF32DV = 64;   // ... of a float32 kernel's slice
constexpr int kNT = 128;     // threads of a tensor-core kernel
constexpr int kF32NT = 256;  // threads of a float32 kernel

struct Wide {
  int d;      // head dim, a multiple of the chunk
  int nsl;    // output slices a row tile
  int nch;    // reduction chunks
};

__device__ __forceinline__ Wide wide_of(int d, int dv, int dc = kDC) {
  return Wide{d, (d + dv - 1) / dv, d / dc};
}

// Rows [row0, row0 + ROWS) of `cols` columns (a multiple of 16 bytes) from
// a (B, S, H, D) slice into shared rows LDT apart, by 16-byte cp.async;
// rows at or past S are zero-filled.
template <typename T, int ROWS, int LDT, int NT>
__device__ __forceinline__ void stage_cols(T* dst, const T* src, int row0,
                                           int seq, size_t row_stride,
                                           int cols) {
  constexpr int PER = 16 / sizeof(T);
  const int cpr = cols / PER;
  for (int c = threadIdx.x; c < ROWS * cpr; c += NT) {
    const int r = c / cpr, ch = c - r * cpr;
    const int row = row0 + r;
    const bool in = row < seq;
    cp_async16(dst + r * LDT + ch * PER,
               src + static_cast<size_t>(in ? row : 0) * row_stride +
                   ch * PER,
               in);
  }
}

// c[n] += A B^T over one chunk of DC columns for one warp: A the warp's 16
// rows of a shared tile at a, B the NN * 8 rows at b (row stride LDT each),
// as warp_rows_dot takes them, accumulating.
template <typename T, int DC, int LDT, int NN>
__device__ __forceinline__ void warp_rows_acc(float (&c)[NN][4], const T* a,
                                              const T* b, int lane) {
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  static_assert(NN % 2 == 0, "n8 tiles in pairs");
#pragma unroll
  for (int kk = 0; kk < DC / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (l8 * 8 + lr) * LDT + kk * 16 + l16 * 8);
#pragma unroll
    for (int n2 = 0; n2 < NN / 2; ++n2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n2 * 16 + l16 * 8 + lr) * LDT + kk * 16 + l8 * 8);
      mma16816<T>(c[2 * n2], af, bf[0], bf[1]);
      mma16816<T>(c[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// o[n] += A B for one warp and one k16 step over the first `cols` columns
// of a slice (B by ldmatrix.trans from rows LDT apart), as warp_step_dot;
// the n16 pairs past `cols` are skipped (cols is the block's, so the test
// does not diverge).
template <typename T, int LDT, int NO>
__device__ __forceinline__ void warp_step_cols(float (&o)[NO][4],
                                               const uint32_t (&af)[4],
                                               const T* b, int lane,
                                               int cols) {
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int n2 = 0; n2 < NO / 2; ++n2) {
    if (n2 * 16 < cols) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (l8 * 8 + lr) * LDT + n2 * 16 + l16 * 8);
      mma16816<T>(o[2 * n2], af, bf[0], bf[1]);
      mma16816<T>(o[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// Keep bits of one m16n8 accumulator tile in the forward's fragment layout
// (rows g and g + 8, columns 2t, 2t + 1): lanes t and t ^ 1 share one
// Philox counter per row; t even draws row g, t odd row g + 8, and each
// passes the other the two words of its columns.  kb[e]: element e.
__device__ __forceinline__ void row_keep_words(uint32_t (&kb)[4],
                                               uint32_t col, uint32_t row,
                                               uint32_t bh, const Dropout& drop,
                                               int t) {
  const bool odd = t & 1;
  const uint4 w = philox4x32_10(
      make_uint4(col >> 2, row + (odd ? 8u : 0u), bh + drop.bh0, 0u),
      drop.k0, drop.k1);
  const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  kb[0] = odd ? x0 : w.x;
  kb[1] = odd ? x1 : w.y;
  kb[2] = odd ? w.z : x0;
  kb[3] = odd ? w.w : x1;
}

// -- the tensor-core kernels (bf16, fp16) -------------------------------------

struct FwdSmem {
  static constexpr int LDC = kDC + 8, LDV = kFwdDV + 8, LDM = kBN + 16;
  template <typename T>
  static constexpr size_t bytes() {
    return sizeof(T) * 2 * ((kBM + kBN) * LDC + kBN * LDV) + 2 * kBM * LDM;
  }
};

// The forward of one block: query rows [q0, q0 + 64) of one (batch, head),
// output columns [c0, c0 + cols) of slice blockIdx.x % nsl.  Warp w holds
// rows 16 w .. + 15 and visits the key tiles below k_hi.  lse may be null
// (no statistic stored; slice 0 stores it otherwise); DROPOUT compiles the
// keep bits in; O is the output's type (T, or float for the ring).
template <typename T, bool DROPOUT, typename O>
__device__ __forceinline__ void wide_forward_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int8_t* __restrict__ mask, const int32_t* __restrict__ k_hi,
    O* __restrict__ out, float* __restrict__ lse, const Args& a,
    const Dropout& drop, int head_dim) {
  using S = FwdSmem;
  constexpr int LDC = S::LDC, LDV = S::LDV, LDM = S::LDM;
  constexpr int NS = kBN / 8, NO = kFwdDV / 8;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // [2][BM][LDC]
  T* sK = sQ + 2 * kBM * LDC;           // [2][BN][LDC]
  T* sV = sK + 2 * kBN * LDC;           // [2][BN][LDV]
  int8_t* sM = reinterpret_cast<int8_t*>(sV + 2 * kBN * LDV);  // [2][BM][LDM]

  const Wide w = wide_of(head_dim, kFwdDV);
  const int qt = blockIdx.x / w.nsl, sl = blockIdx.x - qt * w.nsl;
  const int c0 = sl * kFwdDV, cols = min(kFwdDV, w.d - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int q0 = qt * kBM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * w.d;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * w.d;
  const int n_k = k_hi[qt];
  const int steps = n_k * w.nch;

  auto stage = [&](int i) {
    const int kt = i / w.nch, c = i - kt * w.nch, st = i & 1;
    stage_rows<T, kDC, kBM, LDC, kNT>(sQ + st * kBM * LDC, q + base + c * kDC,
                                      q0, a.seq, row_stride);
    stage_rows<T, kDC, kBN, LDC, kNT>(sK + st * kBN * LDC, k + base + c * kDC,
                                      kt * kBN, a.seq, row_stride);
    if (c == 0) {
      const int kb = kt & 1;
      stage_cols<T, kBN, LDV, kNT>(sV + kb * kBN * LDV, v + base + c0,
                                   kt * kBN, a.seq, row_stride, cols);
      stage_mask<kBM, kBN, LDM, kNT>(
          sM + kb * kBM * LDM,
          mask + static_cast<size_t>(q0) * a.s_pad + kt * kBN, a.s_pad);
    }
  };
  if (steps > 0) {
    stage(0);
    cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_k; ++kt) {
    // S = Q K^T over the chunks: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
    for (int c = 0; c < w.nch; ++c) {
      const int i = kt * w.nch + c;
      cp_async_wait_all();
      __syncthreads();  // chunk i visible; every warp is done with i - 1
      if (i + 1 < steps) {
        stage(i + 1);
        cp_async_commit();
      }
      const int st = i & 1;
      warp_rows_acc<T, kDC, LDC, NS>(s, sQ + st * kBM * LDC + wr * LDC,
                                     sK + st * kBN * LDC, lane);
    }
    const int kb = kt & 1, k0 = kt * kBN;
    const T* tV = sV + kb * kBN * LDV;

    // mask, scale, online softmax, as flash_attention.cu's forward
    const int8_t* tM = sM + kb * kBM * LDM + (wr + g) * LDM + 2 * t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const char2 live =
            *reinterpret_cast<const char2*>(tM + ii * 8 * LDM + 8 * j);
        s[j][2 * ii] = live.x ? s[j][2 * ii] * a.scale : kNegInf;
        s[j][2 * ii + 1] = live.y ? s[j][2 * ii + 1] * a.scale : kNegInf;
        mx[ii] = fmaxf(mx[ii], fmaxf(s[j][2 * ii], s[j][2 * ii + 1]));
      }
    }
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = quad_max(mx[ii]);
      ref[ii] = fmaxf(mx[ii], 0.5f * kNegInf) * kLog2e;
      alpha[ii] = ex2_approx((m[ii] - mx[ii]) * kLog2e);
      m[ii] = mx[ii];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2_approx(fmaf(s[j][e], kLog2e, -ref[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      l[ii] = l[ii] * alpha[ii] + quad_sum(sum[ii]);

    if (DROPOUT && drop.on) {
      const uint32_t row = static_cast<uint32_t>(q0 + wr + g);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t kb4[4];
        row_keep_words(kb4, static_cast<uint32_t>(k0 + 8 * j + 2 * t), row,
                       bh, drop, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = kb4[e] >= drop.threshold ? s[j][e] * drop.inv_keep : 0.f;
      }
    }

    // O = O alpha + P V[:, slice], P rounded to T in the A operand
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s, kk);
      warp_step_cols<T, LDV, NO>(o, pa, tV + kk * 16 * LDV, lane, cols);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = q0 + wr + g + 8 * ii;
    const float l_safe = fmaxf(l[ii], 1e-30f);
    if (row < a.seq) {
      O* dst = out + base + static_cast<size_t>(row) * row_stride + c0 +
               2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (8 * n < cols)
          store2<T, O>(dst + 8 * n, o[n][2 * ii] / l_safe,
                       o[n][2 * ii + 1] / l_safe);
    }
    if (lse != nullptr && sl == 0 && t == 0)
      lse[static_cast<size_t>(bh) * a.s_pad + row] = m[ii] + logf(l_safe);
  }
}

// -- the cluster forward (bf16, fp16; head dims up to 1024) -------------------
//
// The nsl = ceil(D / 128) slice blocks of a query tile are one thread block
// cluster; block r owns columns [128 r, 128 r + 128) of D for both
// products.  It keeps its slice of Q in registers (loaded once) and per key
// tile brings only its slices of K and V (16 KB each, by TMA, completing on
// a barrier of their stage of a two-stage ring, in the 128-byte swizzle
// that wgmma reads) and the mask tile (cp.async).  Per key tile:
//   * its partial logits S_r = Q[:, slice r] K[:, slice r]^T (64 x 64,
//     float32, wgmma m64n64k16 with Q's fragments as the A operand);
//   * a reduce-scatter through distributed shared memory: the 16 rows of
//     row group w (warp w's in every block) are owned by block w % nsl, and
//     every block's warp w stores its partial of them into the owner's
//     shared memory by st.async, which completes the bytes on the owner's
//     barrier (no fence, no cluster barrier).  The owner's four warps take
//     16 keys each and sum the nsl partials in rank order 0 .. nsl - 1 (the
//     plain version's order: ops/flash_attention.py, _logits with
//     chunk=128); mask, scale, online softmax (the row maxima meet in the
//     owner's shared memory) and keep bits as the chunked body; P rounded
//     to T as each warp's A fragment of one k16 step;
//   * an all-gather of P: each owner warp stores its fragment (and alpha)
//     into every block of the cluster by st.async, 2.3 KB a row group, on
//     that block's barrier; then O_r = O_r alpha + P V[:, slice r] (wgmma
//     m64n128k16, or n64 for a 64-column last slice).
// A barrier's phase is armed with the bytes it awaits by its own block's
// thread 0 at the start of each tile.  No buffer needs a second copy: a
// block stores tile k + 1's partials only after it holds tile k's P, which
// the owner sends only after it has read tile k's partials.  The owners
// store the LSE and send every block its rows' sums at the end.  One
// cluster barrier at the start (the barriers initialised, Q read from the
// buffer partials land in) and one at the end (every store landed).  The
// other exchange, an all-gather of the float32 partials (every block
// summing all nsl of them), moves 2.5 to 5 times the bytes through
// distributed shared memory at nsl = 4 to 8; flash_wide_probe.py times it.

constexpr int kClusterMaxSlices = 8;  // blocks of a cluster: the portable most
constexpr int kTile = kBM * kFwdDV;   // elements of a 64 x 128 operand tile

// The two operands a cluster body streams, tile by tile, as TMA tensor maps
// (the forward's and dq's K and V, dk/dv's Q and dO): (B, S, H, D) in boxes
// of one head's 64 rows x 64 columns, swizzled as sw128 lays them out.
struct TileMaps {
  CUtensorMap a, b;
};

// One box of `map` at (column c, head h, row, batch b) into shared memory
// at dst, completing its bytes on the barrier `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c, int h, int row, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(cta_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(row), "r"(b),
      "r"(cta_addr(bar))
      : "memory");
}

struct ClusterSmem {
  static constexpr int LDM = kBN + 16;
  // Row groups a block owns at most: 2 at nsl = 3, else 1.
  static constexpr __host__ __device__ int owned(int nsl) {
    return (4 + nsl - 1) / nsl;
  }
  // sK[2][kTile], sV[2][kTile] (16-bit); sIn[owned][nsl][16 x 64] (float32
  // partial logits of the owned row groups, by sender; Q's slice is staged
  // there before the first tile); sPin[4][4][32] (every row group's P, A
  // fragments by k16 step, uint4), sAin[4][32] and sLin[4][32] (alpha and
  // the row sums, float2); sR[2][4][16] (the owned groups' row maxima, then
  // the warps' shares of the row sums); sM[2][kBM][LDM]; six mbarriers;
  // and up to 1024 bytes to align the tiles to the swizzle's 1024-byte
  // atoms
  static constexpr size_t bytes(int nsl) {
    return 1024 + 2 * 4 * kTile + owned(nsl) * nsl * kBN * 16 * 4 +
           4 * 4 * 32 * 16 + 2 * 4 * 32 * 8 + 2 * 4 * 16 * 4 +
           2 * kBM * LDM + 6 * 8;
  }
};

// Element offset of (row, col) in a 64-row tile of 16-bit values stored as
// 64-column atoms of 128-byte rows, the 16-byte chunks of row r permuted by
// r & 7: the 128-byte swizzle of wgmma's descriptors, conflict-free for
// ldmatrix and for the cp.async rows.
__device__ __forceinline__ int sw128(int row, int col) {
  return (((col >> 6) * kBM + row) << 6) + ((((col >> 3) ^ row) & 7) << 3) +
         (col & 7);
}

// Rows [row0, row0 + 64) of `cols` columns (64 or 128) of a (B, S, H, D)
// slice into a swizzled tile, by 16-byte cp.async from NT threads; rows at
// or past S are zero-filled.
template <typename T, int NT = kNT>
__device__ __forceinline__ void stage_sw128(T* dst, const T* src, int row0,
                                            int seq, size_t row_stride,
                                            int cols) {
  const int lg = cols == kFwdDV ? 4 : 3;  // log2 of the 16-byte chunks a row
  for (int c = threadIdx.x; c < (kBM << lg); c += NT) {
    const int r = c >> lg, col = (c & ((1 << lg) - 1)) << 3;
    const int row = row0 + r;
    const bool in = row < seq;
    cp_async16(dst + sw128(r, col),
               src + static_cast<size_t>(in ? row : 0) * row_stride + col,
               in);
  }
}

// d += A B for the warpgroup: A (64 x 16) from each warp's mma.sync A
// fragment a, B (16 x N) by the descriptor, TRANS_B for a B stored N-major;
// d in the m16n8 accumulator layout of each warp's 16 rows.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, const __nv_bfloat16*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, const __half*) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

// S_r = Q[:, slice] K[:, slice]^T for one key tile: s (the warp's 16 rows x
// 64 keys, m16n8 accumulator layout) from Q's fragments qa and the swizzled
// K tile tK, over the slice's `cols` columns.
template <typename T>
__device__ __forceinline__ void partial_logits(
    float (&s)[kBN / 8][4], const uint32_t (&qa)[kFwdDV / 16][4], const T* tK,
    int cols) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kFwdDV / 16; ++kk)
    if (kk * 16 < cols)  // K-major: the k16 step 32 bytes into its atom
      wgmma_n64<0>(s, qa[kk], sw128_desc(tK + sw128(0, kk * 16), 16, 1024),
                   tK);
  wgmma_commit_wait();
}

// o += A B for one 64-row step of the other axis: pa A's fragments
// (rounded to T), by k16 step, and B the swizzled tile tB (64 rows of the
// step, N-major), its first `cols` columns (64, or 128 with NO = 16): P V
// in the forward, dS K in dq, P^T dO and dS^T Q in dk/dv.
template <typename T, int NO>
__device__ __forceinline__ void out_product(float (&o)[NO][4],
                                            const uint32_t (&pa)[kBN / 16][4],
                                            const T* tB, int cols) {
  static_assert(NO == 8 || NO == kFwdDV / 8, "64 or 128 columns");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    // N-major: the next 64 columns an atom (kBM rows) further, the next 8
    // rows a 1024-byte row group further
    const uint64_t desc = sw128_desc(tB + sw128(kk * 16, 0), kBM * 128, 1024);
    if constexpr (NO == 8)
      wgmma_n64<1>(o, pa[kk], desc, tB);
    else if (cols == kFwdDV)
      wgmma_n128<1>(o, pa[kk], desc, tB);
    else
      wgmma_n64<1>(*reinterpret_cast<float(*)[8][4]>(o), pa[kk], desc, tB);
  }
  wgmma_commit_wait();
}

// The forward of one block of a cluster: query rows [q0, q0 + 64) of one
// (batch, head), output columns [c0, c0 + cols) of slice r, the block's
// rank.  Row group w (warp w's 16 rows in every block) is owned by block w
// % nsl, where it is slot w / nsl (a block owns at most two).  Arguments as
// wide_forward_block's.
template <typename T, bool DROPOUT, typename O>
__device__ __forceinline__ void cluster_forward_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int8_t* __restrict__ mask, const int32_t* __restrict__ k_hi,
    O* __restrict__ out, float* __restrict__ lse, const Args& a,
    const Dropout& drop, int head_dim, const TileMaps& maps) {
  constexpr int LDM = ClusterSmem::LDM;
  constexpr int NS = kBN / 8, NO = kFwdDV / 8, NQ = kFwdDV / 16;
  const int nsl = (head_dim + kFwdDV - 1) / kFwdDV;
  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_addr(smem4);
  T* sK = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(smem4) +
                               (((raw + 1023u) & ~1023u) - raw));
  T* sV = sK + 2 * kTile;
  float4* sIn = reinterpret_cast<float4*>(sV + 2 * kTile);
  uint4* sPin = reinterpret_cast<uint4*>(
      sIn + ClusterSmem::owned(nsl) * nsl * NS * 32);
  float2* sAin = reinterpret_cast<float2*>(sPin + 4 * 4 * 32);
  float2* sLin = sAin + 4 * 32;
  float* sR = reinterpret_cast<float*>(sLin + 4 * 32);
  int8_t* sM = reinterpret_cast<int8_t*>(sR + 2 * 4 * 16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sM + 2 * kBM * LDM);
  T* sQ = reinterpret_cast<T*>(sIn);  // Q's slice, until the first partials

  const int rank = cluster_rank();
  const int qt = blockIdx.x / nsl;
  const int c0 = rank * kFwdDV, cols = min(kFwdDV, head_dim - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int own = warp % nsl, slot = warp / nsl;  // this warp's rows' owner
  const int q0 = qt * kBM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * head_dim;
  const size_t at = static_cast<size_t>(b) * a.seq * row_stride +
                    static_cast<size_t>(h) * head_dim + c0;
  const int n_k = k_hi[qt];

  auto stage = [&](int kt) {
    const int st = kt & 1;
    if (threadIdx.x == 0) {  // K and V by TMA: rows at or past S as zeros
      mbar_expect(bars + 4 + st, 2 * cols * kBN * 2);
      for (int c = 0; c < cols; c += 64) {
        tma_box(sK + st * kTile + c * kBN, &maps.a, c0 + c, h, kt * kBN, b,
                bars + 4 + st);
        tma_box(sV + st * kTile + c * kBN, &maps.b, c0 + c, h, kt * kBN, b,
                bars + 4 + st);
      }
    }
    stage_mask<kBM, kBN, LDM, kNT>(
        sM + st * kBM * LDM,
        mask + static_cast<size_t>(q0) * a.s_pad + kt * kBN, a.s_pad);
  };

  // barriers: the partials of owned slots 0 and 1 (16 x 64 floats from
  // each block), every row group's P and alpha, their row sums; one
  // arrival (this block's thread 0, arming a phase with its bytes) each
  constexpr uint32_t kPartBytes = 16 * kBN * 4;
  constexpr uint32_t kPBytes = 4 * (4 * 32 * 16 + 32 * 8);
  if (threadIdx.x == 0) {  // and the two stages of the K and V ring
#pragma unroll
    for (int i = 0; i < 6; ++i) mbar_init(bars + i, 1);
    mbar_expect(bars + 3, 4 * 32 * 8);
    mbar_init_fence();
  }
  uint32_t qa[NQ][4];
  if (n_k > 0) {
    stage_sw128(sQ, q + at, q0, a.seq, row_stride, cols);
    stage(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk)
      if (kk * 16 < cols)
        ldsm_x4(qa[kk], sQ + sw128(wr + l8 * 8 + lr, kk * 16 + l16 * 8));
  }
  // every block's barriers are set and its Q read before any partial lands
  cluster_barrier();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // of the row groups this block owns: the running max, and this warp's
  // share of the running sum (its 16 keys of each tile)
  float m[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1, k0 = kt * kBN;
    if (kt + 1 < n_k) {  // the other stage: every warp is done with it
      stage(kt + 1);
      cp_async_commit();
    }
    if (threadIdx.x == 0) {  // this tile's phases: the last ones are done
      for (int i = 0; i < ClusterSmem::owned(nsl); ++i)
        if (rank + i * nsl < 4) mbar_expect(bars + i, nsl * kPartBytes);
      mbar_expect(bars + 2, kPBytes);
    }
    mbar_wait(bars + 4 + st, (kt >> 1) & 1);
    {  // this warp's partial logits, into its rows' owner's slot `rank`
      float s[NS][4];
      partial_logits<T>(s, qa, sK + st * kTile, cols);
      const uint32_t dst =
          peer_addr(sIn + (slot * nsl + rank) * NS * 32 + lane, own);
      const uint32_t bar = peer_addr(bars + slot, own);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        st_async(dst + j * 32 * 16,
                 make_float4(s[j][0], s[j][1], s[j][2], s[j][3]), bar);
    }

    // the owned row groups: each warp takes 16 of the 64 keys (n8 tiles
    // 2 warp and 2 warp + 1), sums the nsl partials of its 16 x 16 logits
    // in rank order, and with the block's other warps forms the softmax
    // statistics, then the keep bits and P rounded to T, the A fragment of
    // k16 step `warp` for the group's rows, which it stores into every
    // block of the cluster
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int grp = rank + i * nsl;
      if (grp >= 4) continue;  // the same for every warp of the block
      mbar_wait(bars + i, kt & 1);
      const float4* src = sIn + (i * nsl * NS + 2 * warp) * 32 + lane;
      float sv[2][4];
#pragma unroll 1
      for (int r0 = 0; r0 < nsl; r0 += 4) {
        float4 part[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r0 + u < nsl) {
            part[u][0] = src[(r0 + u) * NS * 32];
            part[u][1] = src[(r0 + u) * NS * 32 + 32];
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r0 + u < nsl)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float4 x = part[u][jj];
              if (r0 + u == 0) {
                sv[jj][0] = x.x, sv[jj][1] = x.y;
                sv[jj][2] = x.z, sv[jj][3] = x.w;
              } else {
                sv[jj][0] += x.x, sv[jj][1] += x.y;
                sv[jj][2] += x.z, sv[jj][3] += x.w;
              }
            }
      }
      // mask, scale; the row maxima over the block's four warps
      const int8_t* tM =
          sM + st * kBM * LDM + (grp * 16 + g) * LDM + 16 * warp + 2 * t;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const char2 live =
              *reinterpret_cast<const char2*>(tM + ii * 8 * LDM + 8 * jj);
          sv[jj][2 * ii] = live.x ? sv[jj][2 * ii] * a.scale : kNegInf;
          sv[jj][2 * ii + 1] = live.y ? sv[jj][2 * ii + 1] * a.scale : kNegInf;
          mx[ii] = fmaxf(mx[ii], fmaxf(sv[jj][2 * ii], sv[jj][2 * ii + 1]));
        }
      }
      float* rm = sR + i * 4 * 16;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        mx[ii] = quad_max(mx[ii]);
        if (t == 0) rm[warp * 16 + g + 8 * ii] = mx[ii];
      }
      __syncthreads();
      float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float mn = m[i][ii];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4)
          mn = fmaxf(mn, rm[w4 * 16 + g + 8 * ii]);
        ref[ii] = fmaxf(mn, 0.5f * kNegInf) * kLog2e;
        alpha[ii] = ex2_approx((m[i][ii] - mn) * kLog2e);
        m[i][ii] = mn;
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv[jj][e] = ex2_approx(fmaf(sv[jj][e], kLog2e, -ref[e >> 1]));
          sum[e >> 1] += sv[jj][e];
        }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
        l[i][ii] = l[i][ii] * alpha[ii] + quad_sum(sum[ii]);
      if (DROPOUT && drop.on) {
        const uint32_t row = static_cast<uint32_t>(q0 + grp * 16 + g);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t kb4[4];
          row_keep_words(kb4,
                         static_cast<uint32_t>(k0 + 16 * warp + 8 * jj + 2 * t),
                         row, bh, drop, t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sv[jj][e] =
                kb4[e] >= drop.threshold ? sv[jj][e] * drop.inv_keep : 0.f;
        }
      }
      uint32_t pa[4];
      acc_to_a<T>(pa, sv, 0);
      const uint4 pw = make_uint4(pa[0], pa[1], pa[2], pa[3]);
      const float2 aw = make_float2(alpha[0], alpha[1]);
#pragma unroll 1
      for (int r = 0; r < nsl; ++r) {
        const uint32_t bar = peer_addr(bars + 2, r);
        st_async(peer_addr(sPin + (grp * 4 + warp) * 32 + lane, r), pw, bar);
        if (warp == 0)
          st_async(peer_addr(sAin + grp * 32 + lane, r), aw, bar);
      }
    }

    // this warp's rows' P and alpha, stored here by their owner
    mbar_wait(bars + 2, kt & 1);
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint4 x = sPin[(warp * 4 + kk) * 32 + lane];
      pa[kk][0] = x.x, pa[kk][1] = x.y, pa[kk][2] = x.z, pa[kk][3] = x.w;
    }
    const float2 al = sAin[warp * 32 + lane];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al.x;
      o[n][1] *= al.x;
      o[n][2] *= al.y;
      o[n][3] *= al.y;
    }
    out_product<T, NO>(o, pa, sV + st * kTile, cols);
    cp_async_wait_all();  // the next tile's mask has landed ...
    __syncthreads();      // ... for every warp, and this tile is free
  }

  // the owned rows' sums (the four warps' shares added in warp order) and
  // LSE, stored into every block; then this warp's rows' sums
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (rank + i * nsl < 4 && t == 0)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
        sR[(i * 4 + warp) * 16 + g + 8 * ii] = l[i][ii];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int grp = rank + i * nsl;
    if (grp >= 4 || warp != 0) continue;
    float ls[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      ls[ii] = 0.f;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4)
        ls[ii] += sR[(i * 4 + w4) * 16 + g + 8 * ii];
      if (lse != nullptr && t == 0)
        lse[static_cast<size_t>(bh) * a.s_pad + q0 + grp * 16 + g + 8 * ii] =
            m[i][ii] + logf(fmaxf(ls[ii], 1e-30f));
    }
    if (n_k > 0)
#pragma unroll 1
      for (int r = 0; r < nsl; ++r)
        st_async(peer_addr(sLin + grp * 32 + lane, r),
                 make_float2(ls[0], ls[1]), peer_addr(bars + 3, r));
  }
  float2 lw = make_float2(0.f, 0.f);
  if (n_k > 0) {
    mbar_wait(bars + 3, 0);
    lw = sLin[warp * 32 + lane];
    cluster_barrier();  // every block's stores have landed: all may leave
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = q0 + wr + g + 8 * ii;
    const float l_safe = fmaxf(ii ? lw.y : lw.x, 1e-30f);
    if (row < a.seq) {
      O* dst = out + at + static_cast<size_t>(row) * row_stride + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (8 * n < cols)
          store2<T, O>(dst + 8 * n, o[n][2 * ii] / l_safe,
                       o[n][2 * ii + 1] / l_safe);
    }
  }
}

// The forward with LSE and dropout; CLUSTER: the cluster body, else the
// chunked one (fwd_plan picks by head dim).
template <typename T, typename O, bool CLUSTER>
__global__ void __launch_bounds__(kNT)
    flash_fwd_lse_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int8_t* __restrict__ mask,
                              const int32_t* __restrict__ k_hi,
                              const int64_t* __restrict__ seed,
                              O* __restrict__ out, float* __restrict__ lse,
                              Args a, uint32_t threshold, float inv_keep,
                              int dropout, int head_dim,
                              const __grid_constant__ TileMaps maps) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, a);
  if constexpr (CLUSTER)
    cluster_forward_block<T, true, O>(q, k, v, mask, k_hi, out, lse, a, drop,
                                      head_dim, maps);
  else
    wide_forward_block<T, true, O>(q, k, v, mask, k_hi, out, lse, a, drop,
                                   head_dim);
}

// The forward without LSE and without dropout (_flash_kernel's function).
template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(kNT)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int8_t* __restrict__ mask,
                          const int32_t* __restrict__ k_hi,
                          T* __restrict__ out, Args a, int head_dim,
                          const __grid_constant__ TileMaps maps) {
  if constexpr (CLUSTER)
    cluster_forward_block<T, false, T>(q, k, v, mask, k_hi, out, nullptr, a,
                                       Dropout{}, head_dim, maps);
  else
    wide_forward_block<T, false, T>(q, k, v, mask, k_hi, out, nullptr, a,
                                    Dropout{}, head_dim);
}

struct DqSmem {
  static constexpr int LDC = kDqDC + 8, LDV = kFwdDV + 8, LDM = kBN + 16;
  template <typename T>
  static constexpr size_t bytes() {
    return sizeof(T) * 2 * ((2 * kBM + 2 * kBN) * LDC + kBN * LDV) +
           2 * kBM * LDM;
  }
};

// dQ of one block of the chunked body: query rows [q0, q0 + 64), dQ columns
// [c0, c0 + cols) of slice blockIdx.x % nsl, over the key tiles below k_hi.
// Per key tile, S and dP accumulate over the chunks of Q, K, dO and V; then
// p, the keep bits, dS = p (dP - delta) rounded to T, and dQ += dS K[:,
// slice].
template <typename T, typename O>
__device__ __forceinline__ void wide_dq_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int8_t* __restrict__ mask,
    const int32_t* __restrict__ k_hi, O* __restrict__ dq, const Args& a,
    const Dropout& drop, int head_dim) {
  using S = DqSmem;
  constexpr int LDC = S::LDC, LDV = S::LDV, LDM = S::LDM;
  constexpr int NS = kBN / 8, NO = kFwdDV / 8;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // [2][BM][LDC] each
  T* sO = sQ + 2 * kBM * LDC;
  T* sK = sO + 2 * kBM * LDC;           // [2][BN][LDC] each
  T* sV = sK + 2 * kBN * LDC;
  T* sKs = sV + 2 * kBN * LDC;          // [2][BN][LDV]: K's slice
  int8_t* sM = reinterpret_cast<int8_t*>(sKs + 2 * kBN * LDV);

  const Wide w = wide_of(head_dim, kFwdDV, kDqDC);
  const int qt = blockIdx.x / w.nsl, sl = blockIdx.x - qt * w.nsl;
  const int c0 = sl * kFwdDV, cols = min(kFwdDV, w.d - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int q0 = qt * kBM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * w.d;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * w.d;
  const int n_k = k_hi[qt];
  const int steps = n_k * w.nch;

  auto stage = [&](int i) {
    const int kt = i / w.nch, c = i - kt * w.nch, st = i & 1;
    const size_t at = base + c * kDqDC;
    stage_rows<T, kDqDC, kBM, LDC, kNT>(sQ + st * kBM * LDC, q + at, q0,
                                        a.seq, row_stride);
    stage_rows<T, kDqDC, kBM, LDC, kNT>(sO + st * kBM * LDC, dout + at, q0,
                                        a.seq, row_stride);
    stage_rows<T, kDqDC, kBN, LDC, kNT>(sK + st * kBN * LDC, k + at,
                                        kt * kBN, a.seq, row_stride);
    stage_rows<T, kDqDC, kBN, LDC, kNT>(sV + st * kBN * LDC, v + at,
                                        kt * kBN, a.seq, row_stride);
    if (c == 0) {
      const int kb = kt & 1;
      stage_cols<T, kBN, LDV, kNT>(sKs + kb * kBN * LDV, k + base + c0,
                                   kt * kBN, a.seq, row_stride, cols);
      stage_mask<kBM, kBN, LDM, kNT>(
          sM + kb * kBM * LDM,
          mask + static_cast<size_t>(q0) * a.s_pad + kt * kBN, a.s_pad);
    }
  };
  if (steps > 0) {
    stage(0);
    cp_async_commit();
  }
  float lse2[2], dlt[2];
  bool alive[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const size_t at = static_cast<size_t>(bh) * a.s_pad + q0 + wr + g + 8 * ii;
    const float lv = lse[at];
    alive[ii] = lv > 0.25f * kNegInf;
    lse2[ii] = lv * kLog2e;
    dlt[ii] = delta[at];
  }
  const float scale2 = a.scale * kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < w.nch; ++c) {
      const int i = kt * w.nch + c;
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < steps) {
        stage(i + 1);
        cp_async_commit();
      }
      const int st = i & 1;
      warp_rows_acc<T, kDqDC, LDC, NS>(s, sQ + st * kBM * LDC + wr * LDC,
                                       sK + st * kBN * LDC, lane);
      warp_rows_acc<T, kDqDC, LDC, NS>(dp, sO + st * kBM * LDC + wr * LDC,
                                       sV + st * kBN * LDC, lane);
    }
    const int kb = kt & 1, k0 = kt * kBN;
    const int8_t* tM = sM + kb * kBM * LDM + (wr + g) * LDM + 2 * t;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const char2 on =
            *reinterpret_cast<const char2*>(tM + ii * 8 * LDM + 8 * j);
        float& p0 = s[j][2 * ii];
        float& p1 = s[j][2 * ii + 1];
        p0 = on.x && alive[ii] ? ex2_approx(fmaf(p0, scale2, -lse2[ii]))
                               : 0.f;
        p1 = on.y && alive[ii] ? ex2_approx(fmaf(p1, scale2, -lse2[ii]))
                               : 0.f;
      }
    }
    if (drop.on) {
      const uint32_t qrow = static_cast<uint32_t>(q0 + wr + g);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t kb4[4];
        row_keep_words(kb4, static_cast<uint32_t>(k0 + 8 * j + 2 * t), qrow,
                       bh, drop, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = kb4[e] >= drop.threshold ? dp[j][e] * drop.inv_keep : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dlt[e >> 1];
    const T* tKs = sKs + kb * kBN * LDV;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t af[4];
      acc_to_a<T>(af, s, kk);
      warp_step_cols<T, LDV, NO>(acc, af, tKs + kk * 16 * LDV, lane, cols);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = q0 + wr + g + 8 * ii;
    if (row < a.seq) {
      O* dst = dq + base + static_cast<size_t>(row) * row_stride + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (8 * n < cols)
          store2<T, O>(dst + 8 * n, acc[n][2 * ii] * a.scale,
                       acc[n][2 * ii + 1] * a.scale);
    }
  }
}

// dk/dv: DS warps share a row group of 16 keys, each computing S^T and
// dP^T for 64 / DS of a q tile's queries and holding DV / DS of the
// slice's dK and dV columns; with DS > 1 the block passes P^T and dS^T,
// rounded to T, through shared memory, as flash_attention.cu's dk/dv does
// at D = 128 and 256.
template <int DS>
struct DkvShape {
  static constexpr int DV = 64 * DS;          // slice columns
  static constexpr int NT = kNT * DS;         // threads
  static constexpr int LDC = kDC + 8, LDS = DV + 8, LDP = kBN + 8;
  static constexpr int LDM = kBM + 16;
  template <typename T>
  static constexpr size_t bytes() {
    return sizeof(T) * 2 * ((2 * kBM + 2 * kBN) * LDC + 2 * kBN * LDS +
                            (DS > 1 ? kBM * LDP : 0)) +
           sizeof(float) * 4 * kBN + 2 * kBN * LDM;
  }
};

// dK and dV of one block of the chunked body: key rows [k0, k0 + 64),
// columns [c0, c0 + cols) of slice blockIdx.x % nsl, over the q tiles from
// q_lo.  Per q tile, S^T and dP^T accumulate over the chunks of K, Q, V and
// dO, key-major as in flash_attention.cu's dk/dv; then p from the staged
// LSE, the keep bits (the transposed layout's shared counters), and dV +=
// (keep P / (1 - r))^T dO[:, slice], dK += dS^T Q[:, slice], the A operands
// rounded to T.  Warp w holds keys 16 (w / DS) .. + 15, queries (w % DS) 64
// / DS .. of a q tile and columns (w % DS) DV / DS .. of the slice.
template <typename T, typename O, int DS>
__device__ __forceinline__ void wide_dkv_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int8_t* __restrict__ mask,
    const int32_t* __restrict__ q_lo, O* __restrict__ dk,
    O* __restrict__ dv, const Args& a, const Dropout& drop, int head_dim) {
  using S = DkvShape<DS>;
  constexpr int DV = S::DV, NT = S::NT;
  constexpr int LDC = S::LDC, LDS = S::LDS, LDP = S::LDP, LDM = S::LDM;
  constexpr int NQ = kBN / (8 * DS);  // n8 tiles of S^T a warp
  constexpr int NO = DV / DS / 8;     // n8 tiles of dK and dV a warp
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);  // [2][BM][LDC] each
  T* sV = sK + 2 * kBM * LDC;
  T* sQ = sV + 2 * kBM * LDC;           // [2][BN][LDC] each
  T* sO = sQ + 2 * kBN * LDC;
  T* sQs = sO + 2 * kBN * LDC;          // [2][BN][LDS]: Q's, dO's slice
  T* sOs = sQs + 2 * kBN * LDS;
  T* sP = sOs + 2 * kBN * LDS;          // DS > 1: P^T, dS^T [BM][LDP] each
  T* sS = sP + kBM * LDP;
  float* sL = reinterpret_cast<float*>(sP + (DS > 1 ? 2 * kBM * LDP : 0));
  float* sD = sL + 2 * kBN;                              // [2][BN] each
  int8_t* sM = reinterpret_cast<int8_t*>(sD + 2 * kBN);  // [2][BN][LDM]

  const Wide w = wide_of(head_dim, DV);
  const int kt = blockIdx.x / w.nsl, sl = blockIdx.x - kt * w.nsl;
  const int c0 = sl * DV, cols = min(DV, w.d - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wr = (warp / DS) * 16;
  const int qc0 = (warp % DS) * 8 * NQ, dcol0 = (warp % DS) * (DV / DS);
  const bool owns_cols = dcol0 < cols;  // the last slice may be narrower
  const int k0 = kt * kBM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * w.d;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * w.d;
  const size_t stats = static_cast<size_t>(bh) * a.s_pad;
  const int num_q = a.s_pad / kBN, qt0 = q_lo[kt];
  const int steps = (num_q - qt0) * w.nch;

  auto stage = [&](int i) {
    const int qt = qt0 + i / w.nch, c = i % w.nch, st = i & 1;
    const int q0 = qt * kBN;
    const size_t at = base + c * kDC;
    stage_rows<T, kDC, kBM, LDC, NT>(sK + st * kBM * LDC, k + at, k0, a.seq,
                                     row_stride);
    stage_rows<T, kDC, kBM, LDC, NT>(sV + st * kBM * LDC, v + at, k0, a.seq,
                                     row_stride);
    stage_rows<T, kDC, kBN, LDC, NT>(sQ + st * kBN * LDC, q + at, q0, a.seq,
                                     row_stride);
    stage_rows<T, kDC, kBN, LDC, NT>(sO + st * kBN * LDC, dout + at, q0,
                                     a.seq, row_stride);
    if (c == 0) {
      const int qb = (qt - qt0) & 1;
      stage_cols<T, kBN, LDS, NT>(sQs + qb * kBN * LDS, q + base + c0, q0,
                                  a.seq, row_stride, cols);
      stage_cols<T, kBN, LDS, NT>(sOs + qb * kBN * LDS, dout + base + c0, q0,
                                  a.seq, row_stride, cols);
      stage_floats<kBN, NT>(sL + qb * kBN, lse + stats + q0);
      stage_floats<kBN, NT>(sD + qb * kBN, delta + stats + q0);
      stage_mask<kBN, kBM, LDM, NT>(
          sM + qb * kBN * LDM,
          mask + static_cast<size_t>(q0) * a.s_pad + k0, a.s_pad);
    }
  };
  if (steps > 0) {
    stage(0);
    cp_async_commit();
  }
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e;
  const int jj = g & 3;

  for (int qt = qt0; qt < num_q; ++qt) {
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < w.nch; ++c) {
      const int i = (qt - qt0) * w.nch + c;
      cp_async_wait_all();
      __syncthreads();  // chunk i visible; every warp is done with i - 1
      if (i + 1 < steps) {
        stage(i + 1);
        cp_async_commit();
      }
      const int st = i & 1;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 8 NQ queries a warp
      warp_rows_acc<T, kDC, LDC, NQ>(s, sK + st * kBM * LDC + wr * LDC,
                                     sQ + st * kBN * LDC + qc0 * LDC, lane);
      warp_rows_acc<T, kDC, LDC, NQ>(dp, sV + st * kBM * LDC + wr * LDC,
                                     sO + st * kBN * LDC + qc0 * LDC, lane);
    }
    const int qb = (qt - qt0) & 1, q0 = qt * kBN;
    const float* tL = sL + qb * kBN;
    const float* tD = sD + qb * kBN;
    const int8_t* tM = sM + qb * kBN * LDM + wr + g;
    // keys wr + g (s[.][0:2]) and wr + g + 8 (s[.][2:4]) at queries
    // qc0 + 8 j + 2 t + {0, 1}: element e is key half e >> 1, query e & 1
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int qc = qc0 + 8 * j + 2 * t;
      const float2 lv = *reinterpret_cast<const float2*>(tL + qc);
      const float2 dl = *reinterpret_cast<const float2*>(tD + qc);
      const float lq[2] = {lv.x, lv.y}, dlq[2] = {dl.x, dl.y};
      uint32_t kb[4] = {0u, 0u, 0u, 0u};
      if (drop.on) {
        const uint32_t key4 =
            static_cast<uint32_t>(k0 + wr + g + 8 * (jj >> 1)) >> 2;
        const uint4 wd = philox4x32_10(
            make_uint4(key4, static_cast<uint32_t>(q0 + qc + (jj & 1)),
                       bh + drop.bh0, 0u),
            drop.k0, drop.k1);
        const uint32_t words[4] = {wd.x, wd.y, wd.z, wd.w};
        uint32_t got[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t send = pick4(words, jj ^ r);
          got[r] = r ? __shfl_xor_sync(0xffffffffu, send, 4 * r) : send;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) kb[e] = pick4(got, jj ^ e);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1, cq = e & 1;
        const bool on = tM[(qc + cq) * LDM + 8 * ii] != 0 &&
                        lq[cq] > 0.25f * kNegInf;
        const float p =
            on ? ex2_approx(fmaf(s[j][e], scale2, -lq[cq] * kLog2e)) : 0.f;
        float pd = p, g_kept = dp[j][e];
        if (drop.on) {
          const bool keep = kb[e] >= drop.threshold;
          pd = keep ? p * drop.inv_keep : 0.f;
          g_kept = keep ? g_kept * drop.inv_keep : 0.f;
        }
        s[j][e] = pd;                      // keep p / (1 - r), for dV
        dp[j][e] = p * (g_kept - dlq[cq]);  // dS, for dK
      }
    }
    const T* tQs = sQs + qb * kBN * LDS + dcol0;
    const T* tOs = sOs + qb * kBN * LDS + dcol0;
    if constexpr (DS == 1) {
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t af[4];
        acc_to_a<T>(af, s, kk);
        warp_step_dot<T, LDS, NO>(dv_acc, af, tOs + kk * 16 * LDS, lane);
        acc_to_a<T>(af, dp, kk);
        warp_step_dot<T, LDS, NO>(dk_acc, af, tQs + kk * 16 * LDS, lane);
      }
    } else {
      // every warp of a row group needs all 64 queries' P^T and dS^T
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int at = (wr + g + 8 * ii) * LDP + qc0 + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(sP + at) =
              pack2<T>(s[j][2 * ii], s[j][2 * ii + 1]);
          *reinterpret_cast<uint32_t*>(sS + at) =
              pack2<T>(dp[j][2 * ii], dp[j][2 * ii + 1]);
        }
      __syncthreads();  // the block's P^T and dS^T of tile qt written
      if (owns_cols) {
        const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const int at = (wr + l8 * 8 + lr) * LDP + kk * 16 + l16 * 8;
          uint32_t af[4];
          ldsm_x4(af, sP + at);
          warp_step_dot<T, LDS, NO>(dv_acc, af, tOs + kk * 16 * LDS, lane);
          ldsm_x4(af, sS + at);
          warp_step_dot<T, LDS, NO>(dk_acc, af, tQs + kk * 16 * LDS, lane);
        }
      }
    }
  }

  if (!owns_cols) return;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = k0 + wr + g + 8 * ii;
    if (row < a.seq) {
      const size_t at =
          base + static_cast<size_t>(row) * row_stride + c0 + dcol0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store2<T, O>(dk + at + 8 * n, dk_acc[n][2 * ii] * a.scale,
                     dk_acc[n][2 * ii + 1] * a.scale);
        store2<T, O>(dv + at + 8 * n, dv_acc[n][2 * ii],
                     dv_acc[n][2 * ii + 1]);
      }
    }
  }
}

// -- the cluster backward (bf16, fp16; head dims up to 1024) ------------------
//
// dq and dk/dv as the cluster forward computes the logits: the nsl slice
// blocks of a row tile of the block's own axis (queries in dq, keys in
// dk/dv) are one cluster, block r owning columns [128 r, 128 r + cols) of D
// for every product.  A block is two warpgroups.  Each holds one resident
// operand's slice as wgmma A fragments, loaded once (dq: Q and dO; dk/dv: K
// and V; staged through the ring's second stage), and per tile of the other
// axis TMA brings the two streamed slices (dq: K and V; dk/dv: Q and dO,
// with the tile's LSE and delta by cp.async) into a two-stage ring.  Per
// tile:
//   * warpgroup 0 computes its slice's partial S (dk/dv: S^T) and
//     warpgroup 1 its partial dP (dP^T), 64 x 64 each on wgmma m64n64k16;
//   * a reduce-scatter: row group w (warp w of each warpgroup) is owned by
//     block w % nsl, and each warp stores its 16 rows' partial into the
//     owner's shared memory, by st.async on the owner's barrier (its own
//     block's by plain stores).  The owner's eight warps take 8 columns
//     each and sum the nsl partials of S and of dP in rank order 0 .. nsl -
//     1 (the plain versions' chunk=128); then p from the LSE, the keep bits,
//     and dS = p (dP_kept - delta) (dk/dv also keep P / (1 - r)), rounded
//     to T as half of an A fragment;
//   * an all-gather: each owner warp stores its halves into every block of
//     the cluster by st.async, 2 KB a row group and operand (dk/dv's P and
//     dS halves in one 16-byte store);
//   * the output products on wgmma m64n128k16 with B the streamed tile
//     already in shared memory: dq's warpgroup 0 dQ += dS K (its warpgroup
//     1 idles; split between the two by columns, on m64n64k16, the product
//     of later tiles came out wrong on the card, on mma.sync it did not:
//     not understood); dk/dv's warpgroup 0 dV += P_kept^T dO, its
//     warpgroup 1 dK += dS^T Q.
// Every block of a cluster so uses bitwise the same P and dS: one owner
// sums each row group's partials, in a fixed order.  Where two exchange
// buffers fit a block (all but dk/dv at 8 slices), tile i + 1's partials
// leave while tile i's fragments travel; with one, once they have come.  No
// buffer is written while it is read: a block sends tile i + 2's partials
// (one buffer: i + 1's) only after it holds tile i's fragments, which every
// owner sends only after reading tile i's partials.  A barrier's phase is
// armed with the bytes it awaits by its own block's thread 0, after its
// last phase completed; bytes may land before the arming.  A tile's slices
// are issued into the ring two tiles ahead, once its stage is free, by
// thread 128 (thread 0 arms the barriers at that point: the issuing thread
// waits its issue out).  No cluster barrier closes the block: every store
// into its shared memory completes on a phase it has waited for.

constexpr int kBwdClusterMaxSlices = kClusterMaxSlices;
constexpr int kBwdNT = 2 * kNT;  // two warpgroups
constexpr size_t kMaxSmem = 232448;  // a block's most dynamic shared memory

struct BwdSmem {
  static constexpr int LDM = kBN + 16;
  // sA[2][kTile], sB[2][kTile] (the streamed slices, 16-bit; the resident
  // ones are staged in stage 1 first); sIn[nb][owned][nsl][2][16 x 64]
  // (float32 partial S and dP of the owned row groups, by buffer and
  // sender); sPin[nb][4][4][32][nf] (every row group's fragments by k16
  // step and lane, uint4: dS, or dk/dv's P and dS by halves); sL[2][64],
  // sD[2][64] (dk/dv: the q tile's LSE and delta); sM[2][64][LDM]; eight
  // mbarriers; up to 1024 bytes to align the tiles to the swizzle's atoms.
  // nb = 2 (pipelined) where that fits.
  static constexpr __host__ __device__ size_t bytes(int nsl, int nf,
                                                    int nb) {
    return 1024 + 2 * 4 * kTile +
           nb * (ClusterSmem::owned(nsl) * nsl * 2 * kBN * 16 * 4 +
                 nf * 4 * 4 * 32 * 16) +
           2 * 2 * kBN * 4 + 2 * kBM * LDM + 8 * 8;
  }
  static constexpr __host__ __device__ int buffers(int nsl, int nf) {
    return bytes(nsl, nf, 2) <= kMaxSmem ? 2 : 1;
  }
};

// One block of the cluster backward: rows [r0, r0 + 64) of its own axis
// (DKV: keys, out0 dK and out1 dV; else queries, out0 dQ) at columns [c0,
// c0 + cols) of slice r, the block's rank, over the tiles of the other axis
// that `table` gives (k_hi or q_lo).  Arguments as the chunked bodies'.
template <typename T, typename O, bool DKV>
__device__ __forceinline__ void cluster_backward_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int8_t* __restrict__ mask,
    const int32_t* __restrict__ table, O* __restrict__ out0,
    O* __restrict__ out1, const Args& a, const Dropout& drop, int head_dim,
    const TileMaps& maps) {
  constexpr int LDM = BwdSmem::LDM;
  constexpr int NS = kBN / 8, NQ = kFwdDV / 16;
  constexpr int NF = DKV ? 2 : 1;  // fragment operands
  constexpr int NO = kFwdDV / 8;   // n8 tiles of an output slice
  constexpr uint32_t kPartBytes = 2 * 16 * kBN * 4;  // S and dP, one sender
  constexpr uint32_t kFragBytes = NF * 4 * 4 * 32 * 16;
  const int nsl = (head_dim + kFwdDV - 1) / kFwdDV;
  const int owned = ClusterSmem::owned(nsl);
  const bool pipe = BwdSmem::buffers(nsl, NF) == 2;
  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_addr(smem4);
  T* sA = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(smem4) +
                               (((raw + 1023u) & ~1023u) - raw));
  T* sB = sA + 2 * kTile;
  float4* sIn = reinterpret_cast<float4*>(sB + 2 * kTile);
  const int in_size = owned * nsl * 2 * NS * 32;  // float4s of a buffer
  uint4* sPin = reinterpret_cast<uint4*>(sIn + (pipe ? 2 : 1) * in_size);
  constexpr int kPinSize = NF * 4 * 4 * 32;  // uint4s of a buffer
  float* sL = reinterpret_cast<float*>(sPin + (pipe ? 2 : 1) * kPinSize);
  float* sD = sL + 2 * kBN;
  int8_t* sM = reinterpret_cast<int8_t*>(sD + 2 * kBN);
  // the partials of buffer u, owned slot s at bars[2 u + s]; the fragments
  // of buffer u at bars[4 + u]; ring stage s at bars[6 + s]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sM + 2 * kBM * LDM);

  const int rank = cluster_rank();
  const int tile = blockIdx.x / nsl;
  const int c0 = rank * kFwdDV, cols = min(kFwdDV, head_dim - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3, wr = wq * 16;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int own = wq % nsl, slot = wq / nsl;  // this warp's rows' owner
  const int r0 = tile * kBM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * head_dim;
  const size_t at = static_cast<size_t>(b) * a.seq * row_stride +
                    static_cast<size_t>(h) * head_dim + c0;
  const size_t stats = static_cast<size_t>(bh) * a.s_pad;
  const int first = DKV ? table[tile] : 0;  // the first tile of the other axis
  const int n = DKV ? a.s_pad / kBN - first : table[tile];
  const float scale2 = a.scale * kLog2e;
  // tile i's exchange buffer, and the parity of its barriers' phase
  auto buf = [&](int i) { return pipe ? i & 1 : 0; };
  auto parity = [&](int i) {
    return static_cast<uint32_t>(pipe ? (i >> 1) & 1 : i & 1);
  };

  // both streamed slices of tile i by TMA (rows past S as zeros), by one
  // thread
  auto stage_tiles = [&](int i) {
    const int st = i & 1, o0 = (first + i) * kBN;
    mbar_expect(bars + 6 + st, 2 * cols * kBN * 2);
    for (int c = 0; c < cols; c += 64) {
      tma_box(sA + st * kTile + c * kBN, &maps.a, c0 + c, h, o0, b,
              bars + 6 + st);
      tma_box(sB + st * kTile + c * kBN, &maps.b, c0 + c, h, o0, b,
              bars + 6 + st);
    }
  };
  // tile i's mask (and dk/dv's LSE and delta) by cp.async, by every thread
  auto stage = [&](int i) {
    const int st = i & 1, o0 = (first + i) * kBN;
    if constexpr (DKV) {
      stage_floats<kBN, kBwdNT>(sL + st * kBN, lse + stats + o0);
      stage_floats<kBN, kBwdNT>(sD + st * kBN, delta + stats + o0);
      stage_mask<kBN, kBM, LDM, kBwdNT>(
          sM + st * kBN * LDM, mask + static_cast<size_t>(o0) * a.s_pad + r0,
          a.s_pad);
    } else {
      stage_mask<kBM, kBN, LDM, kBwdNT>(
          sM + st * kBM * LDM, mask + static_cast<size_t>(r0) * a.s_pad + o0,
          a.s_pad);
    }
  };
  // this block's thread 0 arms tile i's phases of its exchange barriers
  // with the bytes they await (their last phases are done): the partials
  // of the nsl - 1 other blocks (its own it stores itself)
  auto arm = [&](int i) {
    for (int s2 = 0; s2 < owned; ++s2)
      if (rank + s2 * nsl < 4)
        mbar_expect(bars + 2 * buf(i) + s2, (nsl - 1) * kPartBytes);
    mbar_expect(bars + 4 + buf(i), kFragBytes);
  };

  // barriers: one arrival each (this block's thread 0 arming a phase);
  // the cluster's barrier's first half says they are set
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    if (n > 0) arm(0);
  }
  cluster_arrive();
  // dq: the owned row groups' LSE (base 2) and delta, from the rows' own
  // statistics (loaded while the operands stage)
  float lse2[2][2] = {}, dlt[2][2] = {};
  bool alive[2][2] = {};
  if constexpr (!DKV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int grp = rank + i * nsl;
      if (grp >= 4) continue;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const size_t row = stats + r0 + grp * 16 + g + 8 * ii;
        const float lv = lse[row];
        alive[i][ii] = lv > 0.25f * kNegInf;
        lse2[i][ii] = lv * kLog2e;
        dlt[i][ii] = delta[row];
      }
    }
  }
  // the resident slices, staged in the ring's stage 1 (warpgroup c's in
  // sA's or sB's) until they are read into registers
  uint32_t xa[NQ][4];  // Q or K (warpgroup 0), dO or V (warpgroup 1)
  if (n > 0) {
    stage_sw128<T, kBwdNT>(sA + kTile, (DKV ? k : q) + at, r0, a.seq,
                           row_stride, cols);
    stage_sw128<T, kBwdNT>(sB + kTile, (DKV ? v : dout) + at, r0, a.seq,
                           row_stride, cols);
    if (threadIdx.x == 0) stage_tiles(0);
    stage(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk)
      if (kk * 16 < cols)
        ldsm_x4(xa[kk], (wg ? sB : sA) + kTile +
                            sw128(wr + l8 * 8 + lr, kk * 16 + l16 * 8));
    __syncthreads();  // stage 1 read: the copy engine may write it
    if (threadIdx.x == 0 && n > 1) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_tiles(1);
    }
  }
  // every block's barriers are set before any partial lands
  cluster_wait();

  // this warp's partial of tile i (S or dP) into its rows' owner's buffer,
  // slot `rank`: by st.async into another block, by plain stores into this
  // one (seen by the owner's warps after the next __syncthreads)
  auto send_partial = [&](int i) {
    const int st = i & 1;
    mbar_wait(bars + 6 + st, (i >> 1) & 1);
    float s[NS][4];
    partial_logits<T>(s, xa, (wg ? sB : sA) + st * kTile, cols);
    float4* dst = sIn + buf(i) * in_size +
                  ((slot * nsl + rank) * 2 + wg) * NS * 32 + lane;
    if (own == rank) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        dst[j * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    } else {
      const uint32_t peer = peer_addr(dst, own);
      const uint32_t bar = peer_addr(bars + 2 * buf(i) + slot, own);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        st_async(peer + j * 32 * 16,
                 make_float4(s[j][0], s[j][1], s[j][2], s[j][3]), bar);
    }
  };

  float acc[NO][4];  // dQ (warpgroup 0); dV (0) or dK (1)
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (n > 0) send_partial(0);
  __syncthreads();  // the block's own partials of tile 0 seen

  // Per tile i: the owners' work on tile i, then, pipelined, tile i + 1's
  // partials, sent while tile i's fragments travel (with one buffer only
  // once they have come and sit in registers), then tile i's products
  for (int i = 0; i < n; ++i) {
    const int st = i & 1, o0 = (first + i) * kBN;
    if (i + 1 < n) {  // the other stage: every warp is done with it
      stage(i + 1);
      cp_async_commit();
    }

    // the owned row groups: warp u takes columns 8 u .. 8 u + 7 (n8 tile u
    // of the other axis), sums the nsl partials of S and dP in rank order,
    // forms dS (and P), and stores its halves of the A fragments of k16
    // step u / 2 into every block of the cluster
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int grp = rank + s2 * nsl;
      if (grp >= 4) continue;  // the same for every warp of the block
      mbar_wait(bars + 2 * buf(i) + s2, parity(i));
      const float4* src = sIn + buf(i) * in_size +
                          (s2 * nsl * 2 * NS + warp) * 32 + lane;
      float sv[4], dv[4];
#pragma unroll 1
      for (int rb = 0; rb < nsl; rb += 4) {
        float4 part[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (rb + u < nsl) {
            part[u][0] = src[(rb + u) * 2 * NS * 32];
            part[u][1] = src[((rb + u) * 2 + 1) * NS * 32];
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (rb + u < nsl) {
            const float4 x = part[u][0], y = part[u][1];
            if (rb + u == 0) {
              sv[0] = x.x, sv[1] = x.y, sv[2] = x.z, sv[3] = x.w;
              dv[0] = y.x, dv[1] = y.y, dv[2] = y.z, dv[3] = y.w;
            } else {
              sv[0] += x.x, sv[1] += x.y, sv[2] += x.z, sv[3] += x.w;
              dv[0] += y.x, dv[1] += y.y, dv[2] += y.z, dv[3] += y.w;
            }
          }
      }
      // element e: row (of the own axis) grp 16 + g + 8 (e >> 1), column
      // (of the other) 8 warp + 2 t + (e & 1)
      float pk[4], ds[4];
      if constexpr (DKV) {
        // keys rows, queries columns: the transposed layout's counters, as
        // the chunked body draws them
        const int qc = 8 * warp + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(sL + st * kBN + qc);
        const float2 dl = *reinterpret_cast<const float2*>(sD + st * kBN + qc);
        const float lq[2] = {lv.x, lv.y}, dlq[2] = {dl.x, dl.y};
        const int8_t* tM = sM + st * kBN * LDM + grp * 16 + g;
        uint32_t kb[4] = {0u, 0u, 0u, 0u};
        if (drop.on) {
          const int jj = g & 3;
          const uint32_t key4 =
              static_cast<uint32_t>(r0 + grp * 16 + g + 8 * (jj >> 1)) >> 2;
          const uint4 wd = philox4x32_10(
              make_uint4(key4, static_cast<uint32_t>(o0 + qc + (jj & 1)),
                         bh + drop.bh0, 0u),
              drop.k0, drop.k1);
          const uint32_t words[4] = {wd.x, wd.y, wd.z, wd.w};
          uint32_t got[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t send = pick4(words, jj ^ r);
            got[r] = r ? __shfl_xor_sync(0xffffffffu, send, 4 * r) : send;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) kb[e] = pick4(got, jj ^ e);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = e >> 1, cq = e & 1;
          const bool on = tM[(qc + cq) * LDM + 8 * ii] != 0 &&
                          lq[cq] > 0.25f * kNegInf;
          const float p =
              on ? ex2_approx(fmaf(sv[e], scale2, -lq[cq] * kLog2e)) : 0.f;
          float pd = p, g_kept = dv[e];
          if (drop.on) {
            const bool keep = kb[e] >= drop.threshold;
            pd = keep ? p * drop.inv_keep : 0.f;
            g_kept = keep ? g_kept * drop.inv_keep : 0.f;
          }
          pk[e] = pd;                     // keep p / (1 - r), for dV
          ds[e] = p * (g_kept - dlq[cq]);  // dS, for dK
        }
      } else {
        const int8_t* tM =
            sM + st * kBM * LDM + (grp * 16 + g) * LDM + 8 * warp + 2 * t;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const char2 on =
              *reinterpret_cast<const char2*>(tM + ii * 8 * LDM);
          pk[2 * ii] = on.x && alive[s2][ii]
                           ? ex2_approx(fmaf(sv[2 * ii], scale2,
                                             -lse2[s2][ii]))
                           : 0.f;
          pk[2 * ii + 1] = on.y && alive[s2][ii]
                               ? ex2_approx(fmaf(sv[2 * ii + 1], scale2,
                                                 -lse2[s2][ii]))
                               : 0.f;
        }
        if (drop.on) {
          uint32_t kb4[4];
          row_keep_words(kb4, static_cast<uint32_t>(o0 + 8 * warp + 2 * t),
                         static_cast<uint32_t>(r0 + grp * 16 + g), bh, drop,
                         t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dv[e] = kb4[e] >= drop.threshold ? dv[e] * drop.inv_keep : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] = pk[e] * (dv[e] - dlt[s2][e >> 1]);
      }
      // the halves of fragment (grp, k16 step warp / 2): dS (8 bytes a
      // lane), or dk/dv's P and dS together (16 bytes); a half is its A
      // fragment's registers 2 (warp & 1) and 2 (warp & 1) + 1
      const uint32_t d0 = pack2<T>(ds[0], ds[1]), d1 = pack2<T>(ds[2], ds[3]);
      const int fi = (grp * 4 + (warp >> 1)) * 32 + lane;
      uint4* pin = sPin + buf(i) * kPinSize;
#pragma unroll 1
      for (int r = 0; r < nsl; ++r) {
        const uint32_t bar = peer_addr(bars + 4 + buf(i), r);
        if constexpr (DKV)
          st_async(peer_addr(pin + 2 * fi + (warp & 1), r),
                   make_uint4(pack2<T>(pk[0], pk[1]), pack2<T>(pk[2], pk[3]),
                              d0, d1),
                   bar);
        else
          st_async(peer_addr(reinterpret_cast<uint2*>(pin + fi) + (warp & 1),
                             r),
                   make_uint2(d0, d1), bar);
      }
    }
    if (pipe && i + 1 < n) send_partial(i + 1);

    // this warp's rows' fragments, stored here by their owner; the
    // products with the streamed tile
    mbar_wait(bars + 4 + buf(i), parity(i));
    uint32_t pa[kBN / 16][4];
    {
      const uint4* pin = sPin + buf(i) * kPinSize;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const int fi = (wq * 4 + kk) * 32 + lane;
        if constexpr (DKV) {  // P for dV (warpgroup 0), dS for dK (1)
          const uint2* halves = reinterpret_cast<const uint2*>(pin + 2 * fi);
          const uint2 x0 = halves[wg], x1 = halves[2 + wg];
          pa[kk][0] = x0.x, pa[kk][1] = x0.y, pa[kk][2] = x1.x,
          pa[kk][3] = x1.y;
        } else {
          const uint4 x = pin[fi];
          pa[kk][0] = x.x, pa[kk][1] = x.y, pa[kk][2] = x.z, pa[kk][3] = x.w;
        }
      }
    }
    if (!pipe && i + 1 < n) send_partial(i + 1);
    if constexpr (DKV)
      out_product<T, NO>(acc, pa, (wg ? sA : sB) + st * kTile, cols);
    else if (wg == 0)
      out_product<T, NO>(acc, pa, sA + st * kTile, cols);
    cp_async_wait_all();  // the next tile's mask (and statistics) landed ...
    __syncthreads();      // ... for every warp, and stage st is free
    if (threadIdx.x == 0 && i + 1 < n) arm(i + 1);
    // tile i + 2's streamed slices into stage st
    if (threadIdx.x == kNT && i + 2 < n) stage_tiles(i + 2);
  }
  // no closing cluster barrier: every store into this block's shared
  // memory completes on a barrier phase it has waited for, and none comes
  // after its last tile

  // dq: dQ (warpgroup 0); dk/dv: dV (warpgroup 0) or dK (1)
  if (!DKV && wg) return;
  O* out = DKV && wg == 0 ? out1 : out0;
  const float mul = DKV && wg == 0 ? 1.f : a.scale;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = r0 + wr + g + 8 * ii;
    if (row < a.seq) {
      O* dst = out + at + static_cast<size_t>(row) * row_stride + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        if (8 * j < cols)
          store2<T, O>(dst + 8 * j, acc[j][2 * ii] * mul,
                       acc[j][2 * ii + 1] * mul);
    }
  }
}

// dQ; CLUSTER: the cluster body (two warpgroups), else the chunked one
// (bwd_plan picks by head dim).
template <typename T, typename O, bool CLUSTER>
__global__ void __launch_bounds__(CLUSTER ? kBwdNT : kNT)
    flash_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int8_t* __restrict__ mask,
                         const int32_t* __restrict__ k_hi,
                         const int64_t* __restrict__ seed, O* __restrict__ dq,
                         Args a, uint32_t threshold, float inv_keep,
                         int dropout, int head_dim,
                         const __grid_constant__ TileMaps maps) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, a);
  if constexpr (CLUSTER)
    cluster_backward_block<T, O, false>(q, k, v, dout, lse, delta, mask, k_hi,
                                        dq, nullptr, a, drop, head_dim, maps);
  else
    wide_dq_block<T, O>(q, k, v, dout, lse, delta, mask, k_hi, dq, a, drop,
                        head_dim);
}

// dK and dV; CLUSTER as dq's.
template <typename T, typename O, bool CLUSTER>
__global__ void __launch_bounds__(CLUSTER ? kBwdNT : kNT * kDkvDS)
    flash_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int8_t* __restrict__ mask,
                          const int32_t* __restrict__ q_lo,
                          const int64_t* __restrict__ seed,
                          O* __restrict__ dk, O* __restrict__ dv, Args a,
                          uint32_t threshold, float inv_keep, int dropout,
                          int head_dim,
                          const __grid_constant__ TileMaps maps) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, a);
  if constexpr (CLUSTER)
    cluster_backward_block<T, O, true>(q, k, v, dout, lse, delta, mask, q_lo,
                                       dk, dv, a, drop, head_dim, maps);
  else
    wide_dkv_block<T, O, kDkvDS>(q, k, v, dout, lse, delta, mask, q_lo, dk,
                                 dv, a, drop, head_dim);
}

// -- the float32 kernels: CUDA-core bodies ------------------------------------

// Tiles are staged as float32 rows of 64 columns padded by four floats
// (LD = 68), so the float4 reads of a quarter warp hit distinct banks.
// Thread roles, 256 threads: for a 64 x 64 product tile, column
// c = tid % 64 and rows r0 + 4 i (i < 16); for a slice of 64 output
// columns, column tid % 64 and rows tid / 64 + 4 j (j < 16).
constexpr int kF32DC = 64;  // columns of a float32 chunk
constexpr int kLD = kF32DC + 4;
constexpr int kRS = kF32NT / 64, kNR = 64 / kRS;  // 4 row groups, 16 rows

// acc[i] += A[r0 + 4 i] . B[c] over one staged chunk (rows kLD apart).
__device__ __forceinline__ void chunk_dots(const float* sa, const float* sb,
                                           float (&acc)[kNR]) {
  const int c = threadIdx.x % 64, r0 = threadIdx.x / 64;
  for (int d = 0; d < kF32DC; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(&sb[c * kLD + d]);
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(&sa[(r0 + i * kRS) * kLD + d]);
      acc[i] = fmaf(av.x, bv.x, acc[i]);
      acc[i] = fmaf(av.y, bv.y, acc[i]);
      acc[i] = fmaf(av.z, bv.z, acc[i]);
      acc[i] = fmaf(av.w, bv.w, acc[i]);
    }
  }
}

constexpr size_t kF32Tile = sizeof(float) * 64 * kLD;

// The float32 forward: query rows [q0, q0 + 64), output columns
// [c0, c0 + 64) of slice blockIdx.x % nsl.
template <bool DROPOUT>
__device__ __forceinline__ void wide_forward_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int8_t* __restrict__ mask,
    const int32_t* __restrict__ k_hi, float* __restrict__ out,
    float* __restrict__ lse, const Args& a, const Dropout& drop,
    int head_dim) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + 64 * kLD;
  float* sP = sK + 64 * kLD;
  float* sM = sP + 64 * kLD;
  float* sL = sM + 64;
  float* sA = sL + 64;

  const Wide w = wide_of(head_dim, kF32DV);
  const int qt = blockIdx.x / w.nsl, sl = blockIdx.x - qt * w.nsl;
  const int c0 = sl * kF32DV;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kBM;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * w.d;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * w.d;
  for (int r = threadIdx.x; r < kBM; r += kF32NT) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  const int col = threadIdx.x % 64, r0 = threadIdx.x / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kNR];
#pragma unroll
  for (int j = 0; j < kNR; ++j) acc[j] = 0.f;
  const int n_k = k_hi[qt];
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBN;
    float s[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) s[i] = 0.f;
    for (int c = 0; c < w.d / kF32DC; ++c) {
      __syncthreads();
      const size_t at = base + c * kF32DC;
      load_tile<float, kF32DC, kBM, kF32NT>(sQ, q + at, q0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBN, kF32NT>(sK, k + at, k0, a.seq,
                                            row_stride);
      __syncthreads();
      chunk_dots(sQ, sK, s);
    }
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const int r = r0 + i * kRS;
      const bool live =
          mask[static_cast<size_t>(q0 + r) * a.s_pad + k0 + col] != 0;
      sP[r * kLD + col] = live ? s[i] * a.scale : kNegInf;
    }
    __syncthreads();
    // V's slice into sK (the chunks are done with it)
    load_tile<float, kF32DV, kBN, kF32NT>(sK, v + base + c0, k0, a.seq,
                                          row_stride);
    for (int r = warp; r < kBM; r += kF32NT / 32) {
      float mx = kNegInf;
      for (int cc = lane; cc < kBN; cc += 32) mx = fmaxf(mx, sP[r * kLD + cc]);
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float ref = fmaxf(m_new, 0.5f * kNegInf);
      float sum = 0.f;
      for (int cc = lane; cc < kBN; cc += 32) {
        const float pv = expf(sP[r * kLD + cc] - ref);
        sum += pv;
        float pa = pv;
        if (DROPOUT && drop.on)
          pa = drop.keep(bh, q0 + r, k0 + cc) ? pv * drop.inv_keep : 0.f;
        sP[r * kLD + cc] = pa;
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
    for (int j = 0; j < kNR; ++j) acc[j] *= sA[r0 + j * kRS];
    for (int cc = 0; cc < kBN; cc += 4) {
      const float v0 = sK[(cc + 0) * kLD + col];
      const float v1 = sK[(cc + 1) * kLD + col];
      const float v2 = sK[(cc + 2) * kLD + col];
      const float v3 = sK[(cc + 3) * kLD + col];
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const float4 pp = *reinterpret_cast<const float4*>(
            &sP[(r0 + j * kRS) * kLD + cc]);
        acc[j] = fmaf(pp.x, v0, acc[j]);
        acc[j] = fmaf(pp.y, v1, acc[j]);
        acc[j] = fmaf(pp.z, v2, acc[j]);
        acc[j] = fmaf(pp.w, v3, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    const int r = r0 + j * kRS, row = q0 + r;
    if (row < a.seq)
      out[base + static_cast<size_t>(row) * row_stride + c0 + col] =
          acc[j] / fmaxf(sL[r], 1e-30f);
  }
  if (lse != nullptr && sl == 0)
    for (int r = threadIdx.x; r < kBM; r += kF32NT)
      lse[static_cast<size_t>(bh) * a.s_pad + q0 + r] =
          sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

constexpr size_t kFwdF32Smem = 3 * kF32Tile + sizeof(float) * 3 * 64;

__global__ void __launch_bounds__(kF32NT)
    flash_fwd_lse_wide_f32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const int8_t* __restrict__ mask,
                                  const int32_t* __restrict__ k_hi,
                                  const int64_t* __restrict__ seed,
                                  float* __restrict__ out,
                                  float* __restrict__ lse, Args a,
                                  uint32_t threshold, float inv_keep,
                                  int dropout, int head_dim) {
  wide_forward_f32<true>(q, k, v, mask, k_hi, out, lse, a,
                         make_dropout(seed, threshold, inv_keep, dropout, a),
                         head_dim);
}

__global__ void __launch_bounds__(kF32NT)
    flash_fwd_wide_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int8_t* __restrict__ mask,
                              const int32_t* __restrict__ k_hi,
                              float* __restrict__ out, Args a,
                              int head_dim) {
  wide_forward_f32<false>(q, k, v, mask, k_hi, out, nullptr, a, Dropout{},
                          head_dim);
}

constexpr size_t kDqF32Smem = 5 * kF32Tile + sizeof(float) * 2 * 64;

// The float32 dq: query rows [q0, q0 + 64), dQ columns [c0, c0 + 64).
__global__ void __launch_bounds__(kF32NT)
    flash_dq_wide_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int8_t* __restrict__ mask,
                             const int32_t* __restrict__ k_hi,
                             const int64_t* __restrict__ seed,
                             float* __restrict__ dq, Args a,
                             uint32_t threshold, float inv_keep, int dropout,
                             int head_dim) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + 64 * kLD;
  float* sK = sO + 64 * kLD;
  float* sV = sK + 64 * kLD;
  float* sS = sV + 64 * kLD;
  float* sLse = sS + 64 * kLD;
  float* sDelta = sLse + 64;

  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, a);
  const Wide w = wide_of(head_dim, kF32DV);
  const int qt = blockIdx.x / w.nsl, sl = blockIdx.x - qt * w.nsl;
  const int c0 = sl * kF32DV;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kBM;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * w.d;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * w.d;
  for (int r = threadIdx.x; r < kBM; r += kF32NT) {
    sLse[r] = lse[static_cast<size_t>(bh) * a.s_pad + q0 + r];
    sDelta[r] = delta[static_cast<size_t>(bh) * a.s_pad + q0 + r];
  }
  const int col = threadIdx.x % 64, r0 = threadIdx.x / 64;
  float acc[kNR];
#pragma unroll
  for (int j = 0; j < kNR; ++j) acc[j] = 0.f;
  const int n_k = k_hi[qt];
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBN;
    float s[kNR], dp[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < w.d / kF32DC; ++c) {
      __syncthreads();
      const size_t at = base + c * kF32DC;
      load_tile<float, kF32DC, kBM, kF32NT>(sQ, q + at, q0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBM, kF32NT>(sO, dout + at, q0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBN, kF32NT>(sK, k + at, k0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBN, kF32NT>(sV, v + at, k0, a.seq,
                                            row_stride);
      __syncthreads();
      chunk_dots(sQ, sK, s);
      chunk_dots(sO, sV, dp);
    }
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const int r = r0 + i * kRS;
      const bool allowed =
          mask[static_cast<size_t>(q0 + r) * a.s_pad + k0 + col] != 0;
      const float x = allowed ? s[i] * a.scale : kNegInf;
      const float row_lse = sLse[r];
      const float p = row_lse > 0.25f * kNegInf ? expf(x - row_lse) : 0.f;
      float gv = dp[i];
      if (drop.on)
        gv = drop.keep(bh, q0 + r, k0 + col) ? gv * drop.inv_keep : 0.f;
      sS[r * kLD + col] = p * (gv - sDelta[r]);
    }
    __syncthreads();
    // K's slice into sK (the chunks are done with it)
    load_tile<float, kF32DV, kBN, kF32NT>(sK, k + base + c0, k0, a.seq,
                                          row_stride);
    __syncthreads();
    for (int cc = 0; cc < kBN; cc += 4) {
      const float k0v = sK[(cc + 0) * kLD + col];
      const float k1v = sK[(cc + 1) * kLD + col];
      const float k2v = sK[(cc + 2) * kLD + col];
      const float k3v = sK[(cc + 3) * kLD + col];
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const float4 ds = *reinterpret_cast<const float4*>(
            &sS[(r0 + j * kRS) * kLD + cc]);
        acc[j] = fmaf(ds.x, k0v, acc[j]);
        acc[j] = fmaf(ds.y, k1v, acc[j]);
        acc[j] = fmaf(ds.z, k2v, acc[j]);
        acc[j] = fmaf(ds.w, k3v, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    const int row = q0 + r0 + j * kRS;
    if (row < a.seq)
      dq[base + static_cast<size_t>(row) * row_stride + c0 + col] =
          acc[j] * a.scale;
  }
}

constexpr size_t kDkvF32Smem = 6 * kF32Tile + sizeof(float) * 2 * 64;

// The float32 dk/dv: key rows [k0, k0 + 64), columns [c0, c0 + 64).  The
// product tile is [query][key]: thread column c is a key.
__global__ void __launch_bounds__(kF32NT)
    flash_dkv_wide_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int8_t* __restrict__ mask,
                              const int32_t* __restrict__ q_lo,
                              const int64_t* __restrict__ seed,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Args a, uint32_t threshold, float inv_keep,
                              int dropout, int head_dim) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + 64 * kLD;
  float* sQ = sV + 64 * kLD;
  float* sO = sQ + 64 * kLD;
  float* sPd = sO + 64 * kLD;
  float* sS = sPd + 64 * kLD;
  float* sLse = sS + 64 * kLD;
  float* sDelta = sLse + 64;

  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, a);
  const Wide w = wide_of(head_dim, kF32DV);
  const int kt = blockIdx.x / w.nsl, sl = blockIdx.x - kt * w.nsl;
  const int c0 = sl * kF32DV;
  const int h = blockIdx.y, b = blockIdx.z, k0 = kt * kBM;
  const int num_q = a.s_pad / kBN;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * w.d;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * w.d;
  const int col = threadIdx.x % 64, r0 = threadIdx.x / 64;
  float acc_k[kNR], acc_v[kNR];
#pragma unroll
  for (int j = 0; j < kNR; ++j) acc_k[j] = acc_v[j] = 0.f;
  for (int qt = q_lo[kt]; qt < num_q; ++qt) {
    const int q0 = qt * kBN;
    float s[kNR], dp[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < w.d / kF32DC; ++c) {
      __syncthreads();
      const size_t at = base + c * kF32DC;
      load_tile<float, kF32DC, kBN, kF32NT>(sQ, q + at, q0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBN, kF32NT>(sO, dout + at, q0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBM, kF32NT>(sK, k + at, k0, a.seq,
                                            row_stride);
      load_tile<float, kF32DC, kBM, kF32NT>(sV, v + at, k0, a.seq,
                                            row_stride);
      if (c == 0)
        for (int r = threadIdx.x; r < kBN; r += kF32NT) {
          sLse[r] = lse[static_cast<size_t>(bh) * a.s_pad + q0 + r];
          sDelta[r] = delta[static_cast<size_t>(bh) * a.s_pad + q0 + r];
        }
      __syncthreads();
      chunk_dots(sQ, sK, s);
      chunk_dots(sO, sV, dp);
    }
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const int r = r0 + i * kRS;
      const bool allowed =
          mask[static_cast<size_t>(q0 + r) * a.s_pad + k0 + col] != 0;
      const float x = allowed ? s[i] * a.scale : kNegInf;
      const float row_lse = sLse[r];
      const float p = row_lse > 0.25f * kNegInf ? expf(x - row_lse) : 0.f;
      float pd = p, gv = dp[i];
      if (drop.on) {
        const bool kept = drop.keep(bh, q0 + r, k0 + col);
        pd = kept ? p * drop.inv_keep : 0.f;
        gv = kept ? gv * drop.inv_keep : 0.f;
      }
      sPd[r * kLD + col] = pd;
      sS[r * kLD + col] = p * (gv - sDelta[r]);
    }
    __syncthreads();
    // Q's and dO's slices into sQ and sO (the chunks are done with them)
    load_tile<float, kF32DV, kBN, kF32NT>(sQ, q + base + c0, q0, a.seq,
                                          row_stride);
    load_tile<float, kF32DV, kBN, kF32NT>(sO, dout + base + c0, q0, a.seq,
                                          row_stride);
    __syncthreads();
    for (int r = 0; r < kBN; ++r) {
      const float o = sO[r * kLD + col];
      const float qq = sQ[r * kLD + col];
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const int cj = r0 + j * kRS;
        acc_v[j] = fmaf(sPd[r * kLD + cj], o, acc_v[j]);
        acc_k[j] = fmaf(sS[r * kLD + cj], qq, acc_k[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNR; ++j) {
    const int row = k0 + r0 + j * kRS;
    if (row < a.seq) {
      const size_t at = base + static_cast<size_t>(row) * row_stride + c0 + col;
      dk[at] = acc_k[j] * a.scale;
      dv[at] = acc_v[j];
    }
  }
}

// -- launchers ---------------------------------------------------------------

Args args_of(const Launch& L) {
  return Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
              L.heads_total};
}

dim3 grid_of(const Launch& L, int head_dim, int dv) {
  return dim3(L.s_pad / kBM * ((head_dim + dv - 1) / dv), L.heads, L.batch);
}

// Which body runs the 16-bit forwards at a head dim (a multiple of 64 above
// 256): the cluster body of `cluster` blocks, one a slice, up to
// kClusterMaxSlices slices; above, the chunked body (cluster 1).
// ops/flash_attention.py:wide_forward_plan mirrors it.
struct WidePlan {
  int cluster;   // blocks of a cluster (1: the chunked body)
  int last;      // columns of the last slice (64 or kFwdDV)
  int smem;      // dynamic shared bytes of a block
  int chunk;     // columns of the partial sums over D (the logits; dP in
                 // the backward), summed in order
};

WidePlan fwd_plan(int head_dim) {
  const int nsl = (head_dim + kFwdDV - 1) / kFwdDV;
  const int last = head_dim - (nsl - 1) * kFwdDV;
  if (nsl <= kClusterMaxSlices)
    return {nsl, last, static_cast<int>(ClusterSmem::bytes(nsl)), kFwdDV};
  return {1, last, static_cast<int>(FwdSmem::bytes<__nv_bfloat16>()), kDC};
}

// The same for the 16-bit dq (dkv false) and dk/dv: the cluster backward
// up to kBwdClusterMaxSlices slices, above it the chunked bodies.
// ops/flash_attention.py:wide_backward_plan mirrors it.
WidePlan bwd_plan(bool dkv, int head_dim) {
  const int nsl = (head_dim + kFwdDV - 1) / kFwdDV;
  const int last = head_dim - (nsl - 1) * kFwdDV;
  const int nf = dkv ? 2 : 1;
  if (nsl <= kBwdClusterMaxSlices)
    return {nsl, last,
            static_cast<int>(
                BwdSmem::bytes(nsl, nf, BwdSmem::buffers(nsl, nf))),
            kFwdDV};
  if (dkv)
    return {1, last,
            static_cast<int>(DkvShape<kDkvDS>::bytes<__nv_bfloat16>()), kDC};
  return {1, last, static_cast<int>(DqSmem::bytes<__nv_bfloat16>()), kDqDC};
}

// cuTensorMapEncodeTiled, from the driver (no link against it).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The (B, S, H, D) 16-bit tensor at p as TileMaps' boxes: 64 columns of one
// head's 64 rows, in the 128-byte swizzle, rows past S read as zeros.
int tile_map(CUtensorMap* map, const void* p, bool half, const Launch& L,
             int head_dim) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(L.heads),
                              static_cast<cuuint64_t>(L.seq),
                              static_cast<cuuint64_t>(L.batch)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {64, 1, kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launch a cluster body: clusters of `cluster` blocks along x.  A cluster
// that no SM can take is the launch's error (cudaErrorLaunchOutOfResources),
// never a fallback.
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), dim3 grid, int cluster, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  err = cudaOccupancyMaxActiveClusters(&fits, reinterpret_cast<void*>(kern),
                                       &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fits <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LSE, typename O>
int fwd(const void* q, const void* k, const void* v, const int8_t* mask,
        const int32_t* k_hi, const int64_t* seed, void* out, float* lse,
        const Launch& L, int head_dim) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  int err;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid = grid_of(L, head_dim, kF32DV);
    if constexpr (LSE) {
      auto kern = flash_fwd_lse_wide_f32_kernel;
      if ((err = launch_config(kern, kFwdF32Smem))) return err;
      kern<<<grid, kF32NT, kFwdF32Smem, L.stream>>>(
          qt, kt, vt, mask, k_hi, seed, static_cast<float*>(out), lse,
          args_of(L), L.threshold, L.inv_keep, L.dropout, head_dim);
    } else {
      auto kern = flash_fwd_wide_f32_kernel;
      if ((err = launch_config(kern, kFwdF32Smem))) return err;
      kern<<<grid, kF32NT, kFwdF32Smem, L.stream>>>(
          qt, kt, vt, mask, k_hi, static_cast<float*>(out), args_of(L),
          head_dim);
    }
  } else {
    const dim3 grid = grid_of(L, head_dim, kFwdDV);
    const WidePlan p = fwd_plan(head_dim);
    TileMaps maps = {};
    if (p.cluster > 1) {
      const size_t smem = ClusterSmem::bytes(p.cluster);
      const bool half = std::is_same<T, __half>::value;
      if ((err = tile_map(&maps.a, k, half, L, head_dim)) ||
          (err = tile_map(&maps.b, v, half, L, head_dim)))
        return err;
      if constexpr (LSE)
        return launch_cluster(flash_fwd_lse_wide_kernel<T, O, true>, grid,
                              p.cluster, kNT, smem, L.stream, qt, kt, vt, mask,
                              k_hi, seed, static_cast<O*>(out), lse,
                              args_of(L), L.threshold, L.inv_keep, L.dropout,
                              head_dim, maps);
      else
        return launch_cluster(flash_fwd_wide_kernel<T, true>, grid,
                              p.cluster, kNT, smem, L.stream, qt, kt, vt, mask,
                              k_hi, static_cast<T*>(out), args_of(L),
                              head_dim, maps);
    }
    const size_t smem = FwdSmem::bytes<T>();
    if constexpr (LSE) {
      auto kern = flash_fwd_lse_wide_kernel<T, O, false>;
      if ((err = launch_config(kern, smem))) return err;
      kern<<<grid, kNT, smem, L.stream>>>(qt, kt, vt, mask, k_hi, seed,
                                          static_cast<O*>(out), lse,
                                          args_of(L), L.threshold, L.inv_keep,
                                          L.dropout, head_dim, maps);
    } else {
      auto kern = flash_fwd_wide_kernel<T, false>;
      if ((err = launch_config(kern, smem))) return err;
      kern<<<grid, kNT, smem, L.stream>>>(qt, kt, vt, mask, k_hi,
                                          static_cast<T*>(out), args_of(L),
                                          head_dim, maps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, const int8_t* mask,
       const int32_t* k_hi, const int64_t* seed, void* dqp, const Launch& L,
       int head_dim) {
  int err;
  if constexpr (std::is_same<T, float>::value) {
    auto kern = flash_dq_wide_f32_kernel;
    if ((err = launch_config(kern, kDqF32Smem))) return err;
    kern<<<grid_of(L, head_dim, kF32DV), kF32NT, kDqF32Smem, L.stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, k_hi, seed, static_cast<float*>(dqp), args_of(L),
        L.threshold, L.inv_keep, L.dropout, head_dim);
  } else {
    const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
            *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(dout);
    const dim3 grid = grid_of(L, head_dim, kFwdDV);
    const WidePlan p = bwd_plan(false, head_dim);
    TileMaps maps = {};
    if (p.cluster > 1) {
      const bool half = std::is_same<T, __half>::value;
      if ((err = tile_map(&maps.a, k, half, L, head_dim)) ||
          (err = tile_map(&maps.b, v, half, L, head_dim)))
        return err;
      return launch_cluster(flash_dq_wide_kernel<T, O, true>, grid, p.cluster,
                            kBwdNT, p.smem, L.stream, qt, kt, vt, ot, lse,
                            delta, mask, k_hi, seed, static_cast<O*>(dqp),
                            args_of(L), L.threshold, L.inv_keep, L.dropout,
                            head_dim, maps);
    }
    auto kern = flash_dq_wide_kernel<T, O, false>;
    const size_t smem = DqSmem::bytes<T>();
    if ((err = launch_config(kern, smem))) return err;
    kern<<<grid, kNT, smem, L.stream>>>(
        qt, kt, vt, ot, lse, delta, mask, k_hi, seed, static_cast<O*>(dqp),
        args_of(L), L.threshold, L.inv_keep, L.dropout, head_dim, maps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int8_t* mask,
        const int32_t* q_lo, const int64_t* seed, void* dkp, void* dvp,
        const Launch& L, int head_dim) {
  int err;
  if constexpr (std::is_same<T, float>::value) {
    auto kern = flash_dkv_wide_f32_kernel;
    if ((err = launch_config(kern, kDkvF32Smem))) return err;
    kern<<<grid_of(L, head_dim, kF32DV), kF32NT, kDkvF32Smem, L.stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, q_lo, seed, static_cast<float*>(dkp),
        static_cast<float*>(dvp), args_of(L), L.threshold, L.inv_keep,
        L.dropout, head_dim);
  } else {
    using Sh = DkvShape<kDkvDS>;
    static_assert(Sh::DV == kFwdDV, "the bodies' slices agree");
    const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
            *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(dout);
    const dim3 grid = grid_of(L, head_dim, Sh::DV);
    const WidePlan p = bwd_plan(true, head_dim);
    TileMaps maps = {};
    if (p.cluster > 1) {
      const bool half = std::is_same<T, __half>::value;
      if ((err = tile_map(&maps.a, q, half, L, head_dim)) ||
          (err = tile_map(&maps.b, dout, half, L, head_dim)))
        return err;
      return launch_cluster(flash_dkv_wide_kernel<T, O, true>, grid,
                            p.cluster, kBwdNT, p.smem, L.stream, qt, kt, vt,
                            ot, lse, delta, mask, q_lo, seed,
                            static_cast<O*>(dkp), static_cast<O*>(dvp),
                            args_of(L), L.threshold, L.inv_keep, L.dropout,
                            head_dim, maps);
    }
    auto kern = flash_dkv_wide_kernel<T, O, false>;
    const size_t smem = Sh::bytes<T>();
    if ((err = launch_config(kern, smem))) return err;
    kern<<<grid, Sh::NT, smem, L.stream>>>(
        qt, kt, vt, ot, lse, delta, mask, q_lo, seed, static_cast<O*>(dkp),
        static_cast<O*>(dvp), args_of(L), L.threshold, L.inv_keep, L.dropout,
        head_dim, maps);
  }
  return static_cast<int>(cudaGetLastError());
}

bool wide_shapes_ok(int head_dim, int s_pad, int seq) {
  return head_dim >= kDC && head_dim % kDC == 0 && seq > 0 && seq <= s_pad &&
         s_pad % kBM == 0;
}

bool wide_aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

Launch launch_of(int batch, int seq, int heads, int s_pad, float scale,
                 float inv_keep, uint32_t threshold, int dropout,
                 int out_f32, int b0, int h0, int heads_total, void* stream) {
  return Launch{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                dropout, static_cast<cudaStream_t>(stream), out_f32,
                static_cast<uint32_t>(b0) * static_cast<uint32_t>(heads_total) +
                    static_cast<uint32_t>(h0),
                static_cast<uint32_t>(heads_total)};
}

// Dispatch on the dtype code (0 float32, 1 bfloat16, 2 float16) and, for
// 16-bit inputs, out_f32.
#define WIDE_DISPATCH(FN, ...)                                          \
  switch (dtype * 2 + (L.out_f32 ? 1 : 0)) {                            \
    case 0:                                                             \
    case 1: return FN<float, float>(__VA_ARGS__);                       \
    case 2: return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);       \
    case 3: return FN<__nv_bfloat16, float>(__VA_ARGS__);               \
    case 4: return FN<__half, __half>(__VA_ARGS__);                     \
    case 5: return FN<__half, float>(__VA_ARGS__);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);           \
  }

template <typename T, typename O>
int fwd_lse(const void* q, const void* k, const void* v, const int8_t* mask,
            const int32_t* k_hi, const int64_t* seed, void* out, float* lse,
            const Launch& L, int head_dim) {
  return fwd<T, true, O>(q, k, v, mask, k_hi, seed, out, lse, L, head_dim);
}

template <typename T, typename O>
int fwd_plain(const void* q, const void* k, const void* v, const int8_t* mask,
              const int32_t* k_hi, void* out, const Launch& L, int head_dim) {
  return fwd<T, false, T>(q, k, v, mask, k_hi, nullptr, out, nullptr, L,
                          head_dim);
}

}  // namespace

extern "C" {

// The launchers of flash_attention.cu's C interface at head dims above 256
// (any multiple of 64 here): the same arguments, pointers and semantics
// (its extern "C" note); each returns the cudaError_t of the launch and
// never synchronises.

int flash_fwd_wide_launch(const void* q, const void* k, const void* v,
                          const int8_t* mask, const int32_t* k_hi, void* out,
                          int batch, int seq, int heads, int head_dim,
                          int s_pad, int dtype, float scale, void* stream) {
  if (!wide_shapes_ok(head_dim, s_pad, seq) ||
      !wide_aligned({q, k, v, mask, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L = launch_of(batch, seq, heads, s_pad, scale, 1.f, 0u, 0, 0,
                             0, 0, heads, stream);
  WIDE_DISPATCH(fwd_plain, q, k, v, mask, k_hi, out, L, head_dim)
}

int flash_fwd_lse_wide_launch(const void* q, const void* k, const void* v,
                              const int8_t* mask, const int32_t* k_hi,
                              const int64_t* seed, void* out, float* lse,
                              int batch, int seq, int heads, int head_dim,
                              int s_pad, int dtype, float scale,
                              float inv_keep, uint32_t threshold, int dropout,
                              int out_f32, int b0, int h0, int heads_total,
                              void* stream) {
  if (!wide_shapes_ok(head_dim, s_pad, seq) || (dropout && !seed) ||
      !offsets_ok(b0, h0, heads, heads_total) ||
      !wide_aligned({q, k, v, mask, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L = launch_of(batch, seq, heads, s_pad, scale, inv_keep,
                             threshold, dropout, out_f32, b0, h0, heads_total,
                             stream);
  WIDE_DISPATCH(fwd_lse, q, k, v, mask, k_hi, seed, out, lse, L, head_dim)
}

int flash_dq_wide_launch(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const int8_t* mask,
                         const int32_t* k_hi, const int64_t* seed, void* dqp,
                         int batch, int seq, int heads, int head_dim,
                         int s_pad, int dtype, float scale, float inv_keep,
                         uint32_t threshold, int dropout, int out_f32, int b0,
                         int h0, int heads_total, void* stream) {
  if (!wide_shapes_ok(head_dim, s_pad, seq) || (dropout && !seed) ||
      !offsets_ok(b0, h0, heads, heads_total) ||
      !wide_aligned({q, k, v, dout, mask, dqp}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L = launch_of(batch, seq, heads, s_pad, scale, inv_keep,
                             threshold, dropout, out_f32, b0, h0, heads_total,
                             stream);
  WIDE_DISPATCH(dq, q, k, v, dout, lse, delta, mask, k_hi, seed, dqp, L,
                head_dim)
}

int flash_dkv_wide_launch(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const int8_t* mask,
                          const int32_t* q_lo, const int64_t* seed, void* dkp,
                          void* dvp, int batch, int seq, int heads,
                          int head_dim, int s_pad, int dtype, float scale,
                          float inv_keep, uint32_t threshold, int dropout,
                          int out_f32, int b0, int h0, int heads_total,
                          void* stream) {
  if (!wide_shapes_ok(head_dim, s_pad, seq) || (dropout && !seed) ||
      !offsets_ok(b0, h0, heads, heads_total) ||
      !wide_aligned({q, k, v, dout, mask, lse, delta, dkp, dvp}))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L = launch_of(batch, seq, heads, s_pad, scale, inv_keep,
                             threshold, dropout, out_f32, b0, h0, heads_total,
                             stream);
  WIDE_DISPATCH(dkv, q, k, v, dout, lse, delta, mask, q_lo, seed, dkp, dvp, L,
                head_dim)
}

// The 16-bit forwards' plan at a head dim (a multiple of 64 above 256) into
// out[0 .. 4]: blocks of a cluster (1: the chunked body), columns of a
// slice and of the last slice, dynamic shared bytes of a block, columns of
// the logits' partial sums.  Returns 0, or cudaErrorInvalidValue.
int flash_wide_fwd_plan(int head_dim, int* out) {
  if (!wide_shapes_ok(head_dim, kBM, 1) || head_dim <= 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan p = fwd_plan(head_dim);
  const int v[5] = {p.cluster, kFwdDV, p.last, p.smem, p.chunk};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// The 16-bit dq's (dkv 0) or dk/dv's (dkv 1) plan at a head dim, as
// flash_wide_fwd_plan gives the forwards': blocks of a cluster (1: the
// chunked body), columns of a slice and of the last slice, dynamic shared
// bytes of a block, columns of the partial sums of S and dP.
int flash_wide_bwd_plan(int dkv, int head_dim, int* out) {
  if (!wide_shapes_ok(head_dim, kBM, 1) || head_dim <= 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan p = bwd_plan(dkv != 0, head_dim);
  const int v[5] = {p.cluster, kFwdDV, p.last, p.smem, p.chunk};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

const char* flash_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
