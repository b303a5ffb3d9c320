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
// What it computes.  q, k, v, dO are (B, S, H, D) in the input dtype; the
// static mask is an int8 (S_pad, S_pad) tile-aligned square (zero past S)
// with per-tile skip tables: k_hi[q tile] key tiles are visited by the
// forward and dq passes, the dk/dv pass visits q tiles from q_lo[k tile].
// The tables' tiles (Traits<D>: 64 x 64 at D = 32, 64 and 128, 32 x 32 at
// D = 256) fix S_pad, k_hi and the (B, H, S_pad) LSE that dq and dk/dv read.
// Head dims 32, 64, 128 and 256 are compiled, as the Pallas kernels take
// any D (above 256: flash_attention_wide.cu, which shares flash_common.cuh
// with this file); the wrapper runs every other D up to 256 at the next
// compiled one, its operands zero-padded along D and 1/sqrt(D) of the true
// D passed as the scale (zero columns add nothing to a logit, so the
// softmax and LSE are unchanged; the outputs' extra columns are zero and
// are cut off).
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
// (col >> 2, row, (b0 + b)*H_total + h0 + h, 0) under the key (seed[0],
// seed[1]); the element is kept when that word is >= threshold.  b0 is the
// launch's first row in the global batch (0 on one device; a data-parallel
// rank's offset), h0 its first head among H_total (0 and H on one device; a
// tensor-parallel rank holds heads [h0, h0 + H)), so that P ranks draw the
// one-device step's mask.  The launch folds (b0, h0, H_total) into one
// offset per block (make_dropout): one multiply-add a block, none a
// counter.  Every pass regenerates the same mask whatever its tiles or
// fragment layout.
//
// The forward in bf16 and fp16 (flash_fwd_kernel, the server's forward and
// that of the recompute backward, no seed, no LSE; flash_fwd_lse_kernel,
// with the LSE and dropout) is one tensor-core body, mma_forward_block.
// What bounds it: at octo_deep's stages (H=12, D=64, S=224/160/96) a launch
// moves 0.6-1.4 MB at B=1 and 19-44 MB at B=32 for at most 0.11 / 3.4
// GFLOP over the live pairs, so bytes bound it (0.43 us and 13 us at S=224
// at 3.35 TB/s), four times above the tensor cores' bound; at octo_base
// training (B=32, S=74, H=3, D=256) it moves 14.6 MB (4.4 us); only at
// 1024 tokens (B=8, H=12, D=64, 19 GFLOP) do the tensor cores bound it
// (19 us at 989 TFLOP/s).  In practice latency sets its time, 3-20 times
// those bounds: each warp's chain of a tile (wait for the copy, S = Q K^T,
// the softmax, P V) runs in order with four warps to a scheduler, and
// leaving the Q K^T products out, half the tensor-core work, saves only a
// tenth to a fifth of the time (flash_fwd_probe.py; PERF.md, PR 4).
// The design:
//   * Tensor cores: S = Q K^T and O += P V are mma.sync m16n8k16 with
//     float32 accumulators, operands from shared memory by ldmatrix (.trans
//     for V).  Each warp owns 16 query rows, so the row max and sum reduce
//     inside a quad of lanes by shuffles, with no shared round trip and no
//     barrier; P passes from the S accumulator to the A operand of P V in
//     registers, rounded to T there, the point of the JAX cast.  The
//     exponentials are 2^(x log2 e - ref log2 e) on the special-function
//     unit (ex2.approx), as FlashAttention-2 takes them: the accurate expf
//     is several instructions more a logit and the slower at every shape
//     timed (flash_fwd_probe.py).
//   * Asynchronous staging: K, V and the int8 mask tile arrive by 16-byte
//     cp.async.cg copies into a ring of two stages, in T (not float32),
//     rows at or past S zero-filled through the copy's source size; tile
//     kt+1 is in flight while tile kt is computed, one barrier a tile.  Q
//     is loaded once.  Rows are padded by 16 bytes, so the eight row
//     addresses of an ldmatrix and the mask reads of a warp hit distinct
//     banks.
//   * Work in flight: a block is four warps, 64 rows at D = 64 (one mask
//     table tile), and steps through its keys by the table's block_k, so
//     the per-tile running max, and so the rounding of p, are the plain
//     version's.  64-row blocks beat 32-row ones (which put twice the
//     blocks in flight) at B = 1, 8 and 32 and at 1024 tokens
//     (flash_fwd_probe.py), so one choice is compiled.  flash_fwd_kernel is
//     held to 128 registers so four blocks share an SM.  At D = 256 a
//     16 x 256 float32 output accumulator would take 128 registers a
//     thread, so two warps share 16 rows, each holding half of D for P V
//     (64 registers) and both computing the same S (bitwise equal: the
//     same instructions on the same data): 32 rows a block, the table tile.
//   * Dropout in the fragment layout: a thread of an m16n8 accumulator
//     holds columns 2 (lane % 4) + {0, 1} of rows g and g + 8, so lanes
//     t and t ^ 1 need the words of one Philox counter.  Each computes one
//     counter (t even row g, t odd row g + 8) and passes the other's two
//     words by a shuffle, faster than computing both (flash_fwd_probe.py).
// float32 keeps the CUDA-core body below (forward_block): the tensor cores
// have no float32 product that holds the 1e-4 of the card-against-CPU
// checks, and float32 runs only in those checks and the tests.  The launcher
// dispatches by dtype; nothing falls back.
//
// The backward in bf16 and fp16 (flash_dq_kernel, flash_dkv_kernel) runs on
// the tensor cores too.  What bounds it: dq reads Q, K, V, dO and writes dQ
// over three products of the live pairs, dk/dv reads four and writes two
// over four.  At octo_base training (B=32, S=74, H=3, D=256) that is 18.3 /
// 21.9 MB for 0.50 / 0.67 GFLOP, so bytes bound dq / dk/dv (5.4 / 6.5 us at
// 3.35 TB/s); at octo_deep's stages at B=32 (H=12, D=64, S=224/160/96)
// 24-56 / 29-67 MB for 0.9-5.1 / 1.2-6.8 GFLOP, bytes again (7-17 / 9-20
// us); at 1024 tokens (B=8, H=12, D=64) 28.5 / 38.0 GFLOP, the tensor cores
// (29 / 38 us at 989 TFLOP/s).  As in the forward, latency sets the time,
// 3-11 times those bounds on an H100 80GB HBM3 at 700 W (PERF.md, PR 5;
// the shares below are from flash_bwd_probe.py on that card, in bf16 with
// dropout 0.1 at the shapes chip_smoke.py times).
// The design:
//   * dq is the forward with a second product.  Each warp owns 16 query
//     rows; Q and dO are loaded once, the rows' LSE and delta held in
//     registers; K, V and the mask tile arrive through the forward's
//     two-stage cp.async ring.  S = Q K^T and dP = dO V^T take K and V rows
//     as the B operand; p and dS = p (dP - delta) are formed in the
//     accumulator layout and rounded to T into the A operand of
//     dQ += dS K, K by ldmatrix.trans: no shared round trip and no barrier
//     between the products.  The keep bits are the forward's, in its
//     layout.  At D = 256 two warps share 16 rows, each holding half of dQ
//     (64 registers) over one recomputed S and dP, as the forward splits O.
//   * dk/dv runs key-major.  Each warp owns 16 keys; K and V are loaded
//     once; Q, dO, the mask tile and the q tile's LSE and delta arrive
//     through the ring.  S^T = K Q^T and dP^T = V dO^T leave P^T and dS^T in
//     the accumulator layout that is the A operand of
//     dV += (keep P / (1 - r))^T dO and dK += dS^T Q, dO and Q by
//     ldmatrix.trans.  LSE and delta are per column there, read from the
//     staged tile, and the mask is read across its staged [query][key]
//     rows.  At D = 64 a q tile is taken in two passes of 32 queries: the
//     dK and dV accumulators (64 registers) stay, and only one pass's S^T
//     and dP^T are live, 167 registers a thread against 228 in one pass,
//     three blocks an SM against two: 15-19% less time at 1024 tokens and
//     at octo_deep's stages (four passes of 16: 152 registers, 3-5% more).
//     dq keeps a whole 64-key tile in one pass: two passes of 32 bring it
//     to 128 registers but take 5-7% more time.  At D = 256 the dK and dV
//     accumulators of 16 keys would be 256 registers a thread, so four
//     warps split D; each computes a quarter of the q tile's S^T and dP^T,
//     and the block passes P^T and dS^T, rounded to T, through shared
//     memory once a tile (FlashAttention-2's way).  At octo_base training
//     that takes 42% less time than four warps each recomputing the whole
//     S^T and dP^T (2.5 times the tensor-core work) and 20% less than two
//     warps splitting D (244 registers, each recomputing).
//   * Dropout in the transposed layout: a thread holds keys g and g + 8 at
//     queries 2t and 2t + 1 of each n8 tile, and the four lanes
//     16 m + 4 jj + t (jj = 0..3) hold keys 4 m + jj at the same queries:
//     they need the same four Philox counters, each word jj of them.  Each
//     lane draws one counter and the words pass in three shuffle rounds:
//     one Philox a thread an n8 tile in place of four, 5-10% less time at
//     D = 64 (level at octo_base training).
//   * The exponent on ex2.approx, as in the forward: expf takes 6-25% more
//     time in dq and up to 15% more in dk/dv, and the 16-bit limits hold.
//   * Work in flight: blocks of 64 rows (the table tile) at D = 64; 32-row
//     blocks, twice the blocks in flight, take 17-25% more time in dq and
//     28-36% in dk/dv at every D = 64 shape timed.  Holding either kernel
//     to 128 registers (four blocks an SM) spills 72 and 60 bytes and
//     takes 5-7% (dq) and 14-20% (dk/dv) more time.
// The ring-step entries (parallel/ring_attention.py) take 16-bit inputs with
// float32 outputs (out_f32): flash_fwd_lse, dq and dk/dv are instantiated a
// second time with O = float, which changes only the epilogue's store (the
// accumulators are float32 already), so a ring's partials are merged or
// summed before any rounding to the input dtype.
// float32 keeps the CUDA-core bodies of dq and dk/dv (flash_dq_f32_kernel,
// flash_dkv_f32_kernel), dispatched by dtype as the forward is.
//
// The CUDA-core bodies (the float32 forward, dq and dk/dv) are simple and
// right, not fast: float32 fused multiply-adds from shared memory, one block
// per (batch, head, tile).  Tiles are staged in shared memory as float32
// rows padded by four floats, so the float4 reads of a quarter warp hit
// distinct banks; each thread owns one column (key or feature) and a stride
// of rows.  Register budget: with D = 256 a 64 x 256 float32 accumulator
// would take 128 registers a thread at 128 threads, so D = 256 uses 32 x 32
// tiles and 256 threads; D = 64 uses 64 x 64 tiles and 128 threads.  At
// D = 128 dk/dv's two 64 x 128 accumulators would take 128 registers a
// thread at 128 threads, so 64 x 64 tiles take 256 threads (32 + 32 a
// thread, the forward's and dq's 32); its shared memory is the largest,
// 4 ((2 BQ + 2 BK)(D + 4) + 2 BQ (BK + 4) + 2 BQ) = 170,496 bytes, one
// block an SM.  D = 32 takes D = 64's tiles and threads (16 + 16).
//
// Head dims 32 and 128 on the tensor cores (Traits<32>, Traits<128>),
// correct first versions on the D = 64 and D = 256 designs, not tuned:
//   * D = 32 is D = 64 at half the depth: 64-row blocks of four warps, the
//     output accumulator 16 registers (32 at D = 64), flash_fwd_kernel held
//     to 128 registers for four blocks an SM; shared memory 35,840 bytes
//     (forward), 40,960 (dq) and 41,984 (dk/dv) a block at rows of 40
//     elements (80 bytes: the 8 rows of an ldmatrix fall in distinct banks).
//   * D = 128 forward and dq: 64-row blocks of four warps, one warp 16 rows
//     of all 128 columns: the O or dQ accumulator is 16 x 128 / 32 = 64
//     float32 registers a thread beside 32 (S) or 64 (S and dP), as at
//     D = 64 plus 32; no bound on blocks an SM.  Shared memory, rows of 136
//     elements (272 bytes, so the 8 rows of an ldmatrix fall in distinct
//     banks): 2 (64 + 4 x 64) 136 + 2 x 64 x 80 = 97,280 bytes for the
//     forward and 2 (2 x 64 + 4 x 64) 136 + 10,240 = 114,688 for dq, two
//     blocks an SM.
//   * D = 128 dk/dv: two 16 x 128 accumulators would be 128 registers a
//     thread on top of S^T and dP^T, so, as at D = 256, the warps split D:
//     four row groups of 16 keys, two warps each holding 64 columns of dK
//     and dV (64 registers), each computing half a q tile's S^T and dP^T
//     and passing P^T and dS^T through shared memory: 8 warps, 134,144
//     bytes (K, V 34,816; Q, dO ring 69,632; P^T, dS^T 18,432; LSE and
//     delta 1,024; mask ring 10,240), one block an SM.

#include "flash_common.cuh"

namespace {

// Every choice that depends on the head dim, one specialisation a compiled
// dim (the source note gives the reasoning):
//   BQ, BK      the mask tables' tiles (KERNEL_TILES of
//               ops/flash_attention.py); every kernel steps by them;
//   NT          the CUDA-core (float32) kernels' threads;
//   *_RG, *_DS  a tensor-core kernel's row groups of 16 rows (one warp
//               each) and the warps that split D among them;
//   FWD_MIN,    blocks an SM of flash_fwd_kernel and of
//   LSE_MIN     flash_fwd_lse_kernel (__launch_bounds__): at D = 32 and 64
//               four, so at most 128 registers a thread (flash_fwd_kernel
//               at D = 64 takes 140 left alone, three blocks, and more
//               time: PERF.md section 6); at D = 256 flash_fwd_lse_kernel's
//               three are the blocks ptxas reaches unbounded (163
//               registers; 168 with the bound, the same time); at D = 128
//               one: unbounded, ptxas aims flash_fwd_lse_kernel at three
//               blocks (168 registers) and spills, where shared memory
//               holds two (218 registers with the bound, no spill);
//   DKV_SHARE   dk/dv passes P^T and dS^T through shared memory, each of
//               the DKV_DS warps of a row group computing its share of the
//               q tile's S^T and dP^T.
template <int D>
struct Traits;
template <>
struct Traits<32> {
  static constexpr int BQ = 64, BK = 64, NT = 128;
  static constexpr int FWD_RG = 4, FWD_DS = 1, FWD_MIN = 4, LSE_MIN = 4;
  static constexpr int DQ_RG = 4, DQ_DS = 1;
  static constexpr int DKV_RG = 4, DKV_DS = 1;
  static constexpr bool DKV_SHARE = false;
};
template <>
struct Traits<64> {
  static constexpr int BQ = 64, BK = 64, NT = 128;
  static constexpr int FWD_RG = 4, FWD_DS = 1, FWD_MIN = 4, LSE_MIN = 4;
  static constexpr int DQ_RG = 4, DQ_DS = 1;
  static constexpr int DKV_RG = 4, DKV_DS = 1;
  static constexpr bool DKV_SHARE = false;
};
template <>
struct Traits<128> {
  static constexpr int BQ = 64, BK = 64, NT = 256;
  static constexpr int FWD_RG = 4, FWD_DS = 1, FWD_MIN = 1, LSE_MIN = 1;
  static constexpr int DQ_RG = 4, DQ_DS = 1;
  static constexpr int DKV_RG = 4, DKV_DS = 2;
  static constexpr bool DKV_SHARE = true;
};
template <>
struct Traits<256> {
  static constexpr int BQ = 32, BK = 32, NT = 256;
  static constexpr int FWD_RG = 2, FWD_DS = 2, FWD_MIN = 1, LSE_MIN = 3;
  static constexpr int DQ_RG = 2, DQ_DS = 2;
  static constexpr int DKV_RG = 2, DKV_DS = 4;
  static constexpr bool DKV_SHARE = true;
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

// The float32 forward entries: the CUDA-core body, with and without the
// LSE and dropout.
template <int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_fwd_lse_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int8_t* __restrict__ mask,
                             const int32_t* __restrict__ k_hi,
                             const int64_t* __restrict__ seed,
                             float* __restrict__ out, float* __restrict__ lse,
                             Args a, uint32_t threshold, float inv_keep,
                             int dropout) {
  forward_block<float, D, BQ, BK, NT, true>(
      q, k, v, mask, k_hi, out, lse, a,
      make_dropout(seed, threshold, inv_keep, dropout, a));
}

template <int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int8_t* __restrict__ mask,
                         const int32_t* __restrict__ k_hi,
                         float* __restrict__ out, Args a) {
  forward_block<float, D, BQ, BK, NT, false>(q, k, v, mask, k_hi, out,
                                             nullptr, a, Dropout{});
}

// Tiles of the tensor-core forward: RG warps along the rows (16 rows each),
// DS warps along D for P V, BN keys a step (the mask table's block_k); rows
// of Q, K and V padded by 8 elements and mask rows by 16 bytes; K, V and
// mask tiles in a ring of two stages.
template <typename T, int D, int RG, int DS, int BN>
struct MmaFwd {
  static constexpr int BM = 16 * RG, NT = 32 * RG * DS;
  static constexpr int LDT = D + 8, LDM = BN + 16;
  static constexpr size_t smem() {
    return sizeof(T) * (BM + 4 * BN) * LDT + 2 * BM * LDM;
  }
};

// The forward of one block: rows [q0, q0 + BM) of one (batch, head), in T
// on the tensor cores.  Warp w holds rows 16 (w / DS) .. + 15 and output
// columns (w % DS) D / DS .. + D / DS - 1, and visits the key tiles below
// k_hi of the mask table tile it lies in.  lse may be null (no statistic
// stored); DROPOUT compiles the keep bits in.  O is the output's type: T,
// or float for the ring's float32 partials (the epilogue's store only).
template <typename T, int D, int RG, int DS, int BN, bool DROPOUT,
          typename O = T>
__device__ __forceinline__ void mma_forward_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int8_t* __restrict__ mask, const int32_t* __restrict__ k_hi,
    O* __restrict__ out, float* __restrict__ lse, const Args& a,
    const Dropout& drop) {
  using C = MmaFwd<T, D, RG, DS, BN>;
  constexpr int BM = C::BM, NT = C::NT, LDT = C::LDT, LDM = C::LDM;
  constexpr int NS = BN / 8;  // n8 tiles of S a warp
  constexpr int DO = D / DS;  // output columns a warp
  constexpr int NO = DO / 8;  // n8 tiles of O a warp
  constexpr int TBQ = Traits<D>::BQ;
  static_assert(BN == Traits<D>::BK && TBQ % BM == 0, "tiles of the tables");
  static_assert(NS % 2 == 0 && NO % 2 == 0 && D % 16 == 0, "mma tiles");
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sK = sQ + BM * LDT;  // [2][BN][LDT]
  T* sV = sK + 2 * BN * LDT;
  int8_t* sM = reinterpret_cast<int8_t*>(sV + 2 * BN * LDT);  // [2][BM][LDM]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / DS) * 16, dcol0 = (warp % DS) * DO;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * D;
  const int n_k = k_hi[q0 / TBQ];

  auto stage = [&](int kt) {
    const int st = kt & 1, k0 = kt * BN;
    stage_rows<T, D, BN, LDT, NT>(sK + st * BN * LDT, k + base, k0, a.seq,
                                  row_stride);
    stage_rows<T, D, BN, LDT, NT>(sV + st * BN * LDT, v + base, k0, a.seq,
                                  row_stride);
    constexpr int MCH = BN / 16;  // 16-byte chunks of a mask row
#pragma unroll
    for (int i = 0; i < (BM * MCH + NT - 1) / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      if (c < BM * MCH) {
        const int r = c / MCH, ch = c % MCH;
        cp_async16(sM + st * BM * LDM + r * LDM + ch * 16,
                   mask + static_cast<size_t>(q0 + r) * a.s_pad + k0 + ch * 16,
                   true);
      }
    }
  };
  if (n_k > 0) {
    stage_rows<T, D, BM, LDT, NT>(sQ, q + base, q0, a.seq, row_stride);
    stage(0);
    cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // ldmatrix lane roles: row within an 8 x 8 matrix, and which matrix
  const int lr = lane & 7, lm0 = (lane >> 3) & 1, lm1 = lane >> 4;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt visible; every warp is done with kt - 1
    if (kt + 1 < n_k) {
      stage(kt + 1);
      cp_async_commit();
    }
    const int st = kt & 1, k0 = kt * BN;
    const T* tK = sK + st * BN * LDT;
    const T* tV = sV + st * BN * LDT;

    // S = Q K^T: 16 rows x BN keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, sQ + (wr + lm0 * 8 + lr) * LDT + kk * 16 + lm1 * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, tK + (np * 16 + lm1 * 8 + lr) * LDT + kk * 16 + lm0 * 8);
        mma16816<T>(s[2 * np], qa, kb[0], kb[1]);
        mma16816<T>(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // mask, scale, online softmax; this thread holds rows wr + g (s[.][0:2])
    // and wr + g + 8 (s[.][2:4]) at columns 8 j + 2 t + {0, 1}.
    // exp(x - ref) is taken as 2^(x log2 e - ref log2 e)
    const int8_t* tM = sM + st * BM * LDM + (wr + g) * LDM + 2 * t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const char2 live =
            *reinterpret_cast<const char2*>(tM + i * 8 * LDM + 8 * j);
        s[j][2 * i] = live.x ? s[j][2 * i] * a.scale : kNegInf;
        s[j][2 * i + 1] = live.y ? s[j][2 * i + 1] * a.scale : kNegInf;
        mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }
    }
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      ref[i] = fmaxf(mx[i], 0.5f * kNegInf) * kLog2e;
      alpha[i] = ex2_approx((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2_approx(fmaf(s[j][e], kLog2e, -ref[e >> 1]));
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);

    if (DROPOUT && drop.on) {
      const uint32_t row = static_cast<uint32_t>(q0 + wr + g);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint32_t ctr = static_cast<uint32_t>(k0 + 8 * j + 2 * t) >> 2;
        // t even draws row g, t odd row g + 8; each passes the partner the
        // two words of the partner's columns
        const bool odd = t & 1;
        const uint4 w = philox4x32_10(
            make_uint4(ctr, row + (odd ? 8u : 0u), bh + drop.bh0, 0u),
            drop.k0, drop.k1);
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        // [row g, row g + 8][column 2t, 2t + 1]
        const uint32_t bits[2][2] = {{odd ? r0 : w.x, odd ? r1 : w.y},
                                     {odd ? w.z : r0, odd ? w.w : r1}};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = bits[e >> 1][e & 1] >= drop.threshold
                        ? s[j][e] * drop.inv_keep
                        : 0.f;
      }
    }

    // O = O alpha + P V, P rounded to T in the A operand
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < NO / 2; ++dn) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, tV + (kk * 16 + lm0 * 8 + lr) * LDT + dcol0 +
                              dn * 16 + lm1 * 8);
        mma16816<T>(o[2 * dn], pa, vb[0], vb[1]);
        mma16816<T>(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    if (row < a.seq) {
      O* dst = out + base + static_cast<size_t>(row) * row_stride + dcol0 +
               2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2<T, O>(dst + 8 * n, o[n][2 * i] / l_safe,
                     o[n][2 * i + 1] / l_safe);
    }
    if (lse != nullptr && dcol0 == 0 && t == 0)
      lse[static_cast<size_t>(bh) * a.s_pad + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, int RG, int DS, int BN, typename O>
__global__ void __launch_bounds__(32 * RG * DS, Traits<D>::LSE_MIN)
    flash_fwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int8_t* __restrict__ mask,
                         const int32_t* __restrict__ k_hi,
                         const int64_t* __restrict__ seed, O* __restrict__ out,
                         float* __restrict__ lse, Args a, uint32_t threshold,
                         float inv_keep, int dropout) {
  mma_forward_block<T, D, RG, DS, BN, true, O>(
      q, k, v, mask, k_hi, out, lse, a,
      make_dropout(seed, threshold, inv_keep, dropout, a));
}

// The forward without LSE and without dropout: what the JAX package's
// _flash_kernel computes.  A __global__ entry of its own that takes no seed,
// compiles no Philox code and stores no row statistic.
template <typename T, int D, int RG, int DS, int BN>
__global__ void __launch_bounds__(32 * RG * DS, Traits<D>::FWD_MIN)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int8_t* __restrict__ mask,
                     const int32_t* __restrict__ k_hi, T* __restrict__ out,
                     Args a) {
  mma_forward_block<T, D, RG, DS, BN, false>(
      q, k, v, mask, k_hi, out, nullptr, a, Dropout{});
}

// -- the float32 backward: the CUDA-core bodies ---------------------------------

template <int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int8_t* __restrict__ mask,
                        const int32_t* __restrict__ k_hi,
                        const int64_t* __restrict__ seed,
                        float* __restrict__ dq, Args a, uint32_t threshold,
                        float inv_keep, int dropout) {
  using T = float;
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
  const Dropout drop =
      make_dropout(seed, threshold, inv_keep, dropout, a);

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

template <int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
    flash_dkv_f32_kernel(const float* __restrict__ q,
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
                         int dropout) {
  using T = float;
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
  const Dropout drop =
      make_dropout(seed, threshold, inv_keep, dropout, a);

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

// Tiles of the tensor-core backward.  A block holds BM = 16 RG rows of its
// own axis (queries for dq, keys for dk/dv), 16 a warp, and steps along the
// other axis by BN, the mask table's tile there; DS warps split D for the
// second products.  Operand rows are padded by 8 elements, mask rows by 16
// bytes.
template <typename T, int D, int RG, int DS, int BN>
struct MmaBwd {
  static constexpr int BM = 16 * RG, NT = 32 * RG * DS;
  static constexpr int LDT = D + 8, LDP = BN + 8;
  // dq: Q and dO [BM][LDT]; K and V [2][BN][LDT]; mask [2][BM][BN + 16]
  static constexpr size_t dq_smem() {
    return sizeof(T) * (2 * BM + 4 * BN) * LDT + 2 * BM * (BN + 16);
  }
  // dk/dv: K and V [BM][LDT]; Q and dO [2][BN][LDT]; with share P^T and
  // dS^T [BM][LDP]; LSE and delta [2][BN] float; mask [2][BN][BM + 16]
  // (its rows are queries)
  static constexpr size_t dkv_smem(bool share) {
    return sizeof(T) * ((2 * BM + 4 * BN) * LDT + (share ? 2 * BM * LDP : 0)) +
           sizeof(float) * 4 * BN + 2 * BN * (BM + 16);
  }
};

// dQ of one block: query rows [q0, q0 + BM) of one (batch, head), over the
// key tiles below k_hi of the table tile the rows lie in, each in one pass
// of NC n8 tiles of keys (the structure of dk/dv's passes; a whole tile is
// the faster at D = 64, see the source note).  Warp w holds rows
// 16 (w / DS) .. + 15 and dQ columns (w % DS) D / DS .. + D / DS - 1; the DS
// warps of a row group compute the same S and dP (bitwise equal).
template <typename T, int D, int RG, int DS, int BN, typename O>
__global__ void __launch_bounds__(32 * RG * DS)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int8_t* __restrict__ mask,
                    const int32_t* __restrict__ k_hi,
                    const int64_t* __restrict__ seed, O* __restrict__ dq,
                    Args a, uint32_t threshold, float inv_keep, int dropout) {
  using C = MmaBwd<T, D, RG, DS, BN>;
  constexpr int BM = C::BM, NT = C::NT, LDT = C::LDT, LDM = BN + 16;
  constexpr int NS = BN / 8;  // n8 tiles of S a warp in a tile
  constexpr int NC = NS;      // ... in a pass
  constexpr int DO = D / DS;            // dQ columns a warp
  constexpr int NO = DO / 8;  // n8 tiles of dQ a warp
  constexpr int TBQ = Traits<D>::BQ;
  static_assert(BN == Traits<D>::BK && TBQ % BM == 0, "tiles of the tables");
  static_assert(NS % NC == 0 && NC % 2 == 0 && NO % 2 == 0, "mma tiles");
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sO = sQ + BM * LDT;
  T* sK = sO + BM * LDT;  // [2][BN][LDT]
  T* sV = sK + 2 * BN * LDT;
  int8_t* sM = reinterpret_cast<int8_t*>(sV + 2 * BN * LDT);  // [2][BM][LDM]

  const Dropout drop =
      make_dropout(seed, threshold, inv_keep, dropout, a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / DS) * 16, dcol0 = (warp % DS) * DO;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * D;
  const int n_k = k_hi[q0 / TBQ];

  auto stage = [&](int kt) {
    const int st = kt & 1, k0 = kt * BN;
    stage_rows<T, D, BN, LDT, NT>(sK + st * BN * LDT, k + base, k0, a.seq,
                                  row_stride);
    stage_rows<T, D, BN, LDT, NT>(sV + st * BN * LDT, v + base, k0, a.seq,
                                  row_stride);
    stage_mask<BM, BN, LDM, NT>(sM + st * BM * LDM,
                                mask + static_cast<size_t>(q0) * a.s_pad + k0,
                                a.s_pad);
  };
  if (n_k > 0) {
    stage_rows<T, D, BM, LDT, NT>(sQ, q + base, q0, a.seq, row_stride);
    stage_rows<T, D, BM, LDT, NT>(sO, dout + base, q0, a.seq, row_stride);
    stage(0);
    cp_async_commit();
  }
  // rows wr + g and wr + g + 8: the LSE times log2 e, whether the row has a
  // live key, and delta, in registers for the whole loop
  float lse2[2], dlt[2];
  bool alive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = static_cast<size_t>(bh) * a.s_pad + q0 + wr + g + 8 * i;
    const float l = lse[at];
    alive[i] = l > 0.25f * kNegInf;
    lse2[i] = l * kLog2e;
    dlt[i] = delta[at];
  }
  const float scale2 = a.scale * kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt visible; every warp is done with kt - 1
    if (kt + 1 < n_k) {
      stage(kt + 1);
      cp_async_commit();
    }
    const int st = kt & 1, k0 = kt * BN;
    const T* tK = sK + st * BN * LDT;
    const T* tV = sV + st * BN * LDT;

#pragma unroll 1
    for (int pass = 0; pass < NS / NC; ++pass) {
      const int kp = 8 * NC * pass;  // the pass's first key in the tile
      // S = Q K^T and dP = dO V^T: 16 rows x 8 NC keys a warp
      float s[NC][4], dp[NC][4];
      warp_rows_dot<T, D, LDT, NC>(s, sQ + wr * LDT, tK + kp * LDT, lane);
      warp_rows_dot<T, D, LDT, NC>(dp, sO + wr * LDT, tV + kp * LDT, lane);

      // p = exp(s scale - lse), as 2^(s scale log2 e - lse log2 e), on the
      // live keys of live rows, else 0.  This thread holds rows wr + g
      // (s[.][0:2]) and wr + g + 8 (s[.][2:4]) at keys kp + 8 j + 2 t +
      // {0, 1}.
      const int8_t* tM = sM + st * BM * LDM + (wr + g) * LDM + kp + 2 * t;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const char2 on =
              *reinterpret_cast<const char2*>(tM + i * 8 * LDM + 8 * j);
          float& p0 = s[j][2 * i];
          float& p1 = s[j][2 * i + 1];
          p0 = on.x && alive[i] ? ex2_approx(fmaf(p0, scale2, -lse2[i]))
                                : 0.f;
          p1 = on.y && alive[i] ? ex2_approx(fmaf(p1, scale2, -lse2[i]))
                                : 0.f;
        }
      }
      if (drop.on) {
        // the forward's keep bits in its fragment layout: lanes t and t ^ 1
        // need one counter (key >> 2) for each row; t even draws row g, t
        // odd row g + 8, and each passes the other the two words of its
        // keys
        const bool odd = t & 1;
        const uint32_t qrow =
            static_cast<uint32_t>(q0 + wr + g) + (odd ? 8u : 0u);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const uint4 w = philox4x32_10(
              make_uint4(static_cast<uint32_t>(k0 + kp + 8 * j + 2 * t) >> 2,
                         qrow, bh + drop.bh0, 0u),
              drop.k0, drop.k1);
          const uint32_t x0 =
              __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
          const uint32_t x1 =
              __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
          // row g: keys 2t, 2t + 1; then row g + 8
          const uint32_t kb[4] = {odd ? x0 : w.x, odd ? x1 : w.y,
                                  odd ? w.z : x0, odd ? w.w : x1};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] =
                kb[e] >= drop.threshold ? dp[j][e] * drop.inv_keep : 0.f;
        }
      }

      // dS = p (dP - delta), rounded to T in the A operand of dQ += dS K
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dlt[e >> 1];
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t af[4];
        acc_to_a<T>(af, s, kk);
        warp_step_dot<T, LDT, NO>(acc, af, tK + (kp + kk * 16) * LDT + dcol0,
                                  lane);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row < a.seq) {
      O* dst = dq + base + static_cast<size_t>(row) * row_stride + dcol0 +
               2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2<T, O>(dst + 8 * n, acc[n][2 * i] * a.scale,
                     acc[n][2 * i + 1] * a.scale);
    }
  }
}

// dK and dV of one block: key rows [k0, k0 + BM) of one (batch, head), over
// the q tiles from q_lo of the table tile the keys lie in.  Warp w holds keys
// 16 (w / DS) .. + 15 and dK, dV columns (w % DS) D / DS .. + D / DS - 1.
// Without SHARE the DS warps of a row group compute the same S^T and dP^T
// over all BN queries, in passes of at most 32 queries (S^T and dP^T of one
// pass live at a time); with SHARE each computes BN / DS of the queries and
// the block passes P^T and dS^T, rounded to T, through shared memory.
template <typename T, int D, int RG, int DS, int BN, bool SHARE, typename O>
__global__ void __launch_bounds__(32 * RG * DS)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int8_t* __restrict__ mask,
                     const int32_t* __restrict__ q_lo,
                     const int64_t* __restrict__ seed, O* __restrict__ dk,
                     O* __restrict__ dv, Args a, uint32_t threshold,
                     float inv_keep, int dropout) {
  using C = MmaBwd<T, D, RG, DS, BN>;
  constexpr int BM = C::BM, NT = C::NT, LDT = C::LDT, LDP = C::LDP;
  constexpr int LDM = BM + 16;
  constexpr int NQ = SHARE ? BN / (8 * DS) : BN / 8;  // n8 tiles of S^T
  constexpr int NC = NQ > 4 ? 4 : NQ;  // n8 tiles of S^T a pass
  constexpr int DO = D / DS;  // dK and dV columns a warp
  constexpr int NO = DO / 8;  // their n8 tiles
  constexpr int TBK = Traits<D>::BK;
  static_assert(BN == Traits<D>::BQ && TBK % BM == 0, "tiles of the tables");
  static_assert(NQ % NC == 0 && (SHARE ? NQ == NC : NC % 2 == 0) &&
                    NO % 2 == 0 && BN % 16 == 0,
                "mma tiles");
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + BM * LDT;
  T* sQ = sV + BM * LDT;  // [2][BN][LDT]
  T* sO = sQ + 2 * BN * LDT;
  T* sP = sO + 2 * BN * LDT;  // SHARE: P^T, then dS^T, [BM][LDP] each
  T* sS = sP + BM * LDP;
  float* sL = reinterpret_cast<float*>(sP + (SHARE ? 2 * BM * LDP : 0));
  float* sD = sL + 2 * BN;                              // [2][BN] each
  int8_t* sM = reinterpret_cast<int8_t*>(sD + 2 * BN);  // [2][BN][LDM]

  const Dropout drop =
      make_dropout(seed, threshold, inv_keep, dropout, a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / DS) * 16, dcol0 = (warp % DS) * DO;
  const int qc0 = SHARE ? (warp % DS) * 8 * NQ : 0;  // the warp's queries
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const size_t row_stride = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * a.seq * row_stride +
                      static_cast<size_t>(h) * D;
  const size_t stats = static_cast<size_t>(bh) * a.s_pad;
  const int num_q = a.s_pad / BN, qt0 = q_lo[k0 / TBK];

  auto stage = [&](int qt) {
    const int st = (qt - qt0) & 1, q0 = qt * BN;
    stage_rows<T, D, BN, LDT, NT>(sQ + st * BN * LDT, q + base, q0, a.seq,
                                  row_stride);
    stage_rows<T, D, BN, LDT, NT>(sO + st * BN * LDT, dout + base, q0, a.seq,
                                  row_stride);
    stage_floats<BN, NT>(sL + st * BN, lse + stats + q0);
    stage_floats<BN, NT>(sD + st * BN, delta + stats + q0);
    stage_mask<BN, BM, LDM, NT>(sM + st * BN * LDM,
                                mask + static_cast<size_t>(q0) * a.s_pad + k0,
                                a.s_pad);
  };
  if (qt0 < num_q) {
    stage_rows<T, D, BM, LDT, NT>(sK, k + base, k0, a.seq, row_stride);
    stage_rows<T, D, BM, LDT, NT>(sV, v + base, k0, a.seq, row_stride);
    stage(qt0);
    cp_async_commit();
  }
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e;
  // keys g + 8 i of lanes 16 m + 4 jj + t (jj = 0..3) share key >> 2, and
  // their word of a Philox block is jj
  const int jj = g & 3;

  for (int qt = qt0; qt < num_q; ++qt) {
    cp_async_wait_all();
    __syncthreads();  // tile qt visible; every warp is done with qt - 1
    if (qt + 1 < num_q) {
      stage(qt + 1);
      cp_async_commit();
    }
    const int st = (qt - qt0) & 1, q0 = qt * BN;
    const T* tQ = sQ + st * BN * LDT;
    const T* tO = sO + st * BN * LDT;
    const float* tL = sL + st * BN;
    const float* tD = sD + st * BN;
    const int8_t* tM = sM + st * BN * LDM + wr + g;

#pragma unroll 1
    for (int pass = 0; pass < NQ / NC; ++pass) {
      const int qp = qc0 + 8 * NC * pass;  // the pass's first query
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 8 NC queries a warp
      float s[NC][4], dp[NC][4];
      warp_rows_dot<T, D, LDT, NC>(s, sK + wr * LDT, tQ + qp * LDT, lane);
      warp_rows_dot<T, D, LDT, NC>(dp, sV + wr * LDT, tO + qp * LDT, lane);

      // This thread holds keys wr + g (s[.][0:2]) and wr + g + 8 (s[.][2:4])
      // at queries qp + 8 j + 2 t + {0, 1}: element e is key half e >> 1,
      // query e & 1.  LSE and delta are per query.
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int qc = qp + 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(tL + qc);
        const float2 dl = *reinterpret_cast<const float2*>(tD + qc);
        const float lq[2] = {l.x, l.y}, dlq[2] = {dl.x, dl.y};
        uint32_t kb[4] = {0u, 0u, 0u, 0u};
        if (drop.on) {
          // the four lanes jj = 0..3 need the same four counters (key >> 2
          // of key half e >> 1, query e & 1), each word jj of them: lane jj
          // draws counter jj, and in round r sends word jj ^ r to lane
          // jj ^ r, receiving word jj of counter jj ^ r
          const uint32_t key4 =
              static_cast<uint32_t>(k0 + wr + g + 8 * (jj >> 1)) >> 2;
          const uint4 w = philox4x32_10(
              make_uint4(key4, static_cast<uint32_t>(q0 + qc + (jj & 1)),
                         bh + drop.bh0, 0u),
              drop.k0, drop.k1);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
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
          const int i = e >> 1, c = e & 1;
          const bool on = tM[(qc + c) * LDM + 8 * i] != 0 &&
                          lq[c] > 0.25f * kNegInf;
          const float p =
              on ? ex2_approx(fmaf(s[j][e], scale2, -lq[c] * kLog2e)) : 0.f;
          float pd = p, g_kept = dp[j][e];
          if (drop.on) {
            const bool keep = kb[e] >= drop.threshold;
            pd = keep ? p * drop.inv_keep : 0.f;
            g_kept = keep ? g_kept * drop.inv_keep : 0.f;
          }
          s[j][e] = pd;                        // keep p / (1 - r), for dV
          dp[j][e] = p * (g_kept - dlq[c]);    // dS, for dK
        }
      }

      // dV += (keep P / (1 - r))^T dO and dK += dS^T Q, the A operands
      // rounded to T
      if constexpr (!SHARE) {
#pragma unroll
        for (int kk = 0; kk < NC / 2; ++kk) {
          const size_t at = (qp + kk * 16) * LDT + dcol0;
          uint32_t af[4];
          acc_to_a<T>(af, s, kk);
          warp_step_dot<T, LDT, NO>(dv_acc, af, tO + at, lane);
          acc_to_a<T>(af, dp, kk);
          warp_step_dot<T, LDT, NO>(dk_acc, af, tQ + at, lane);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = (wr + g + 8 * i) * LDP + qp + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(sP + at) =
                pack2<T>(s[j][2 * i], s[j][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(sS + at) =
                pack2<T>(dp[j][2 * i], dp[j][2 * i + 1]);
          }
        __syncthreads();  // the block's P^T and dS^T of tile qt written
        const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const int at = (wr + l8 * 8 + lr) * LDP + kk * 16 + l16 * 8;
          uint32_t af[4];
          ldsm_x4(af, sP + at);
          warp_step_dot<T, LDT, NO>(dv_acc, af, tO + kk * 16 * LDT + dcol0,
                                    lane);
          ldsm_x4(af, sS + at);
          warp_step_dot<T, LDT, NO>(dk_acc, af, tQ + kk * 16 * LDT + dcol0,
                                    lane);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wr + g + 8 * i;
    if (row < a.seq) {
      const size_t at =
          base + static_cast<size_t>(row) * row_stride + dcol0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store2<T, O>(dk + at + 8 * n, dk_acc[n][2 * i] * a.scale,
                     dk_acc[n][2 * i + 1] * a.scale);
        store2<T, O>(dv + at + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

template <int D>
constexpr size_t fwd_smem() {
  using Tl = Traits<D>;
  return sizeof(float) * ((Tl::BQ + 2 * Tl::BK) * (D + 4) +
                          Tl::BQ * (Tl::BK + 4) + 3 * Tl::BQ);
}
template <int D>
constexpr size_t dq_smem() {
  using Tl = Traits<D>;
  return sizeof(float) * ((2 * Tl::BQ + 2 * Tl::BK) * (D + 4) +
                          Tl::BQ * (Tl::BK + 4) + 2 * Tl::BQ);
}
template <int D>
constexpr size_t dkv_smem() {
  using Tl = Traits<D>;
  return sizeof(float) * ((2 * Tl::BQ + 2 * Tl::BK) * (D + 4) +
                          2 * Tl::BQ * (Tl::BK + 4) + 2 * Tl::BQ);
}

// One tensor-core forward launch, with LSE (and dropout) or without, at
// the row groups and D split of Traits<D>.
template <typename T, int D, bool LSE, typename O = T>
int mma_fwd(const void* q, const void* k, const void* v, const int8_t* mask,
            const int32_t* k_hi, const int64_t* seed, void* out, float* lse,
            const Launch& L) {
  constexpr int RG = Traits<D>::FWD_RG, DS = Traits<D>::FWD_DS;
  constexpr int BN = Traits<D>::BK;
  using C = MmaFwd<T, D, RG, DS, BN>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(mask))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = C::smem();
  const dim3 grid(L.s_pad / C::BM, L.heads, L.batch);
  const Args args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
                  L.heads_total};
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  int err;
  if constexpr (LSE) {
    auto kern = flash_fwd_lse_kernel<T, D, RG, DS, BN, O>;
    if ((err = launch_config(kern, smem))) return err;
    kern<<<grid, C::NT, smem, L.stream>>>(qt, kt, vt, mask, k_hi, seed,
                                          static_cast<O*>(out), lse, args,
                                          L.threshold, L.inv_keep, L.dropout);
  } else {
    auto kern = flash_fwd_kernel<T, D, RG, DS, BN>;
    if ((err = launch_config(kern, smem))) return err;
    kern<<<grid, C::NT, smem, L.stream>>>(qt, kt, vt, mask, k_hi,
                                          static_cast<T*>(out), args);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const int8_t* mask,
        const int32_t* k_hi, const int64_t* seed, void* out, float* lse,
        const Launch& L) {
  if constexpr (!std::is_same<T, float>::value) {
    if (L.out_f32)
      return mma_fwd<T, D, true, float>(q, k, v, mask, k_hi, seed, out, lse,
                                        L);
    return mma_fwd<T, D, true>(q, k, v, mask, k_hi, seed, out, lse, L);
  } else {
    using Tl = Traits<D>;
    auto kern = flash_fwd_lse_f32_kernel<D, Tl::BQ, Tl::BK, Tl::NT>;
    const size_t smem = fwd_smem<D>();
    int err;
    if ((err = launch_config(kern, smem))) return err;
    const dim3 grid(L.s_pad / Tl::BQ, L.heads, L.batch);
    kern<<<grid, Tl::NT, smem, L.stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, k_hi, seed,
        static_cast<float*>(out), lse,
        Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
             L.heads_total}, L.threshold,
        L.inv_keep, L.dropout);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int fwd_plain(const void* q, const void* k, const void* v, const int8_t* mask,
              const int32_t* k_hi, void* out, const Launch& L) {
  if constexpr (!std::is_same<T, float>::value) {
    return mma_fwd<T, D, false>(q, k, v, mask, k_hi, nullptr, out, nullptr,
                                L);
  } else {
    using Tl = Traits<D>;
    auto kern = flash_fwd_f32_kernel<D, Tl::BQ, Tl::BK, Tl::NT>;
    const size_t smem = fwd_smem<D>();
    int err;
    if ((err = launch_config(kern, smem))) return err;
    const dim3 grid(L.s_pad / Tl::BQ, L.heads, L.batch);
    kern<<<grid, Tl::NT, smem, L.stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, k_hi, static_cast<float*>(out),
        Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, 0u,
             L.heads_total});
    return static_cast<int>(cudaGetLastError());
  }
}

// One tensor-core dq launch at the row groups and D split of Traits<D>
// (the DS warps of a row group split D for dS K over one recomputed S and
// dP).
template <typename T, int D, typename O>
int mma_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int8_t* mask,
           const int32_t* k_hi, const int64_t* seed, void* dqp,
           const Launch& L) {
  constexpr int RG_DQ = Traits<D>::DQ_RG, DS_DQ = Traits<D>::DQ_DS;
  constexpr int BN = Traits<D>::BK;
  using C = MmaBwd<T, D, RG_DQ, DS_DQ, BN>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(mask))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kern = flash_dq_kernel<T, D, RG_DQ, DS_DQ, BN, O>;
  const size_t smem = C::dq_smem();
  int err;
  if ((err = launch_config(kern, smem))) return err;
  const dim3 grid(L.s_pad / C::BM, L.heads, L.batch);
  kern<<<grid, C::NT, smem, L.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      k_hi, seed, static_cast<O*>(dqp),
      Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
             L.heads_total}, L.threshold,
      L.inv_keep, L.dropout);
  return static_cast<int>(cudaGetLastError());
}

// One tensor-core dk/dv launch at the row groups, D split and sharing of
// Traits<D> (with DKV_SHARE the DS warps of a row group each compute their
// share of a q tile's S^T and dP^T and pass P^T and dS^T through shared
// memory).
template <typename T, int D, typename O>
int mma_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const int8_t* mask,
            const int32_t* q_lo, const int64_t* seed, void* dkp, void* dvp,
            const Launch& L) {
  constexpr int RG_DKV = Traits<D>::DKV_RG, DS_DKV = Traits<D>::DKV_DS;
  constexpr bool SHARE_DKV = Traits<D>::DKV_SHARE;
  constexpr int BN = Traits<D>::BQ;
  using C = MmaBwd<T, D, RG_DKV, DS_DKV, BN>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(mask) || !aligned16(lse) || !aligned16(delta))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto kern = flash_dkv_kernel<T, D, RG_DKV, DS_DKV, BN, SHARE_DKV, O>;
  const size_t smem = C::dkv_smem(SHARE_DKV);
  int err;
  if ((err = launch_config(kern, smem))) return err;
  const dim3 grid(L.s_pad / C::BM, L.heads, L.batch);
  kern<<<grid, C::NT, smem, L.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      q_lo, seed, static_cast<O*>(dkp), static_cast<O*>(dvp),
      Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
             L.heads_total}, L.threshold,
      L.inv_keep, L.dropout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, const int8_t* mask,
       const int32_t* k_hi, const int64_t* seed, void* dqp, const Launch& L) {
  if constexpr (!std::is_same<T, float>::value) {
    if (L.out_f32)
      return mma_dq<T, D, float>(q, k, v, dout, lse, delta, mask, k_hi, seed,
                                 dqp, L);
    return mma_dq<T, D, T>(q, k, v, dout, lse, delta, mask, k_hi, seed, dqp,
                           L);
  } else {
    using Tl = Traits<D>;
    auto kern = flash_dq_f32_kernel<D, Tl::BQ, Tl::BK, Tl::NT>;
    const size_t smem = dq_smem<D>();
    int err;
    if ((err = launch_config(kern, smem))) return err;
    const dim3 grid(L.s_pad / Tl::BQ, L.heads, L.batch);
    kern<<<grid, Tl::NT, smem, L.stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, k_hi, seed, static_cast<float*>(dqp),
        Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
             L.heads_total}, L.threshold,
        L.inv_keep, L.dropout);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int8_t* mask,
        const int32_t* q_lo, const int64_t* seed, void* dkp, void* dvp,
        const Launch& L) {
  if constexpr (!std::is_same<T, float>::value) {
    if (L.out_f32)
      return mma_dkv<T, D, float>(q, k, v, dout, lse, delta, mask, q_lo, seed,
                                  dkp, dvp, L);
    return mma_dkv<T, D, T>(q, k, v, dout, lse, delta, mask, q_lo, seed, dkp,
                            dvp, L);
  } else {
    using Tl = Traits<D>;
    auto kern = flash_dkv_f32_kernel<D, Tl::BQ, Tl::BK, Tl::NT>;
    const size_t smem = dkv_smem<D>();
    int err;
    if ((err = launch_config(kern, smem))) return err;
    const dim3 grid(L.s_pad / Tl::BK, L.heads, L.batch);
    kern<<<grid, Tl::NT, smem, L.stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, q_lo, seed, static_cast<float*>(dkp),
        static_cast<float*>(dvp),
        Args{L.batch, L.seq, L.heads, L.s_pad, L.scale, L.bh0,
             L.heads_total}, L.threshold,
        L.inv_keep, L.dropout);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
bool tiles_divide(int s_pad, int seq) {
  return seq > 0 && seq <= s_pad && s_pad % Traits<D>::BQ == 0 &&
         s_pad % Traits<D>::BK == 0;
}

// The compiled head dims; any other is refused (the wrapper zero-pads D to
// the next one up).
bool shapes_ok(int head_dim, int s_pad, int seq) {
  switch (head_dim) {
    case 32: return tiles_divide<32>(s_pad, seq);
    case 64: return tiles_divide<64>(s_pad, seq);
    case 128: return tiles_divide<128>(s_pad, seq);
    case 256: return tiles_divide<256>(s_pad, seq);
    default: return false;
  }
}

// Dispatch on (dtype code, head dim): 0 float32, 1 bfloat16, 2 float16.
#define FLASH_DISPATCH(FN, ...)                                   \
  switch (dtype * 1000 + head_dim) {                              \
    case 32: return FN<float, 32>(__VA_ARGS__);                   \
    case 64: return FN<float, 64>(__VA_ARGS__);                   \
    case 128: return FN<float, 128>(__VA_ARGS__);                 \
    case 256: return FN<float, 256>(__VA_ARGS__);                 \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);         \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);        \
    case 1256: return FN<__nv_bfloat16, 256>(__VA_ARGS__);        \
    case 2032: return FN<__half, 32>(__VA_ARGS__);                \
    case 2064: return FN<__half, 64>(__VA_ARGS__);                \
    case 2128: return FN<__half, 128>(__VA_ARGS__);               \
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
// out_f32 (flash_fwd_lse, dq, dk/dv): 16-bit inputs write out, dq, dk and dv
// as float32 (the ring-step partials of parallel/ring_attention.py); float32
// inputs write float32 either way.  b0 >= 0 (the same three): the first row
// of the launch's batch in the global batch, which offsets the dropout
// counter.  h0 >= 0 and heads_total >= h0 + heads (the same three): the
// launch holds heads [h0, h0 + heads) of heads_total, which place its
// dropout counters among the whole attention's.

int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const int8_t* mask, const int32_t* k_hi, void* out,
                     int batch, int seq, int heads, int head_dim, int s_pad,
                     int dtype, float scale, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, 1.f, 0u, 0,
                 static_cast<cudaStream_t>(stream), 0, 0u,
                 static_cast<uint32_t>(heads)};
  FLASH_DISPATCH(fwd_plain, q, k, v, mask, k_hi, out, L)
}

int flash_fwd_lse_launch(const void* q, const void* k, const void* v,
                         const int8_t* mask, const int32_t* k_hi,
                         const int64_t* seed, void* out, float* lse, int batch,
                         int seq, int heads, int head_dim, int s_pad,
                         int dtype, float scale, float inv_keep,
                         uint32_t threshold, int dropout, int out_f32,
                         int b0, int h0, int heads_total, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq) || (dropout && !seed) ||
      !offsets_ok(b0, h0, heads, heads_total))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                 dropout, static_cast<cudaStream_t>(stream), out_f32,
                 static_cast<uint32_t>(b0) *
                         static_cast<uint32_t>(heads_total) +
                     static_cast<uint32_t>(h0),
                 static_cast<uint32_t>(heads_total)};
  FLASH_DISPATCH(fwd, q, k, v, mask, k_hi, seed, out, lse, L)
}

int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int8_t* mask, const int32_t* k_hi,
                    const int64_t* seed, void* dqp, int batch, int seq,
                    int heads, int head_dim, int s_pad, int dtype,
                    float scale, float inv_keep, uint32_t threshold,
                    int dropout, int out_f32, int b0, int h0,
                    int heads_total, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq) || (dropout && !seed) ||
      !offsets_ok(b0, h0, heads, heads_total))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                 dropout, static_cast<cudaStream_t>(stream), out_f32,
                 static_cast<uint32_t>(b0) *
                         static_cast<uint32_t>(heads_total) +
                     static_cast<uint32_t>(h0),
                 static_cast<uint32_t>(heads_total)};
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, mask, k_hi, seed, dqp, L)
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int8_t* mask, const int32_t* q_lo,
                     const int64_t* seed, void* dkp, void* dvp, int batch,
                     int seq, int heads, int head_dim, int s_pad, int dtype,
                     float scale, float inv_keep, uint32_t threshold,
                     int dropout, int out_f32, int b0, int h0,
                     int heads_total, void* stream) {
  if (!shapes_ok(head_dim, s_pad, seq) || (dropout && !seed) ||
      !offsets_ok(b0, h0, heads, heads_total))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{batch, seq, heads, s_pad, scale, inv_keep, threshold,
                 dropout, static_cast<cudaStream_t>(stream), out_f32,
                 static_cast<uint32_t>(b0) *
                         static_cast<uint32_t>(heads_total) +
                     static_cast<uint32_t>(h0),
                 static_cast<uint32_t>(heads_total)};
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, mask, q_lo, seed, dkp, dvp,
                 L)
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
