// Backward of a stride-1 VALID max-pool, for Hopper (sm_90a), on the layout
// the caller hands it: NHWC (channels_last, C innermost) or NCHW, for x and
// for g each.
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
// raster order, as the JAX kernel adds its nine shifted slices.  dx comes
// out in x's layout.
//
// What bounds it on the H100.  Its bytes: x and g are read once and dx
// written once (about 307 MB in bfloat16 at octo_base training, B=32:
// N=1600 patches, C=64, 23x23 in, 21x21 out - 0.092 ms at 3.35 TB/s).  The
// first design (one element of 2 bytes a thread a load, converted to
// float32 in shared memory, eight planes a block, load -> winners ->
// gather with nothing overlapped) sat at 9x that, level with torch's own
// backward, and on the embedder's channels_last tensors its wrapper first
// copied x and g to NCHW, another 200 MB.  At 3.35 TB/s and about a
// microsecond of latency an SM needs some 25 KB in flight; the compute,
// some 20 compares and adds an element done one lane at a time, is within
// a factor of two of the byte time too.
//
// What the design does about it:
// - A block takes one image and a chunk of 32 bytes of channels (16 in
//   bfloat16 / float16, 8 in float32) and stages x and g in their own
//   layouts with 16-byte cp.async copies, all in flight at once: in NHWC a
//   pixel's chunk is one 32-byte sector, in NCHW the chunk is one
//   contiguous run.  No layout copy, in the wrapper or here.
// - About 44 KB of shared memory a block in every dtype (x, g and the
//   winning slots, each at the chunk's 32 bytes a pixel), so five blocks
//   share an SM: while one computes, the others' loads are in flight, some
//   30 KB a block.  (16 bytes a block, nine blocks an SM, and 64 bytes, two,
//   were both slower in pool_sampler_probe.py.)
// - Two 16-bit channels in one 32-bit word: the max (max.NaN, so a NaN
//   window's max is NaN and matches nothing), the compare and the add of
//   dx (correctly rounded in the 16-bit type, which is what the float32
//   add then the rounding of the plain version gives) are one packed
//   instruction for both.
// - Each thread walks one column down the plane with the window's rows in
//   registers: a row's max and the column of its first maximum are found
//   once, as the row enters; a window's winner is the first of its rows
//   whose max equals the window's, at that row's column.  The gather keeps
//   the last rows of winning slots and g in registers likewise, so every
//   staged value is read from shared memory once a pass.
// - dx is built in the shared memory x held and leaves with 16-byte
//   stores.  No atomics: deterministic.
// The 3x3 window is compiled as such; any other window up to 8x8 runs the
// same body with its sizes read at run time.  A window wider or taller than
// 8 (whose rings would not fit a thread's registers) runs a second body,
// pool_bwd_wide_kernel, on the same staging, whose winner search is
// separable: a row pass keeps each row window's max and the column of its
// first maximum in shared memory (prefix and suffix maxima over blocks of
// the window's width, a few operations an element whatever the window), a
// column pass picks each window's first row holding its max, and the
// gather goes window row by window row, each run of windows won by one
// pixel adding its cotangents in slot order: work in proportion to the
// windows, spread evenly over the threads.  The row arrays take 2 h ow
// positions beside the plane; where they do not fit at any chunk (planes
// of about 100 a side and more at 9x9), the column pass reads each window
// whole instead, in the register body's footprint, so the wide body takes
// every plane that fits x, g and one array of winners.  (Reading every
// window whole,
// some 768 shared-memory reads an element at 16x16, was slower than
// torch's backward; pool_sampler_probe.py times that body beside this
// one.  A gather by pixel, or by row of pixels, leaves most of a warp idle
// behind the pixel that won the most windows.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWideThreads = 384;   // the wide body: a lane a thread
constexpr int kMaxWindow = 8;
constexpr int kChunkBytes = 32;   // a block's channels at one pixel
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

// Packed lanes of a 32-bit word: two 16-bit channels, or one float.
template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int N = 1;
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;"
        : "=f"(r)
        : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
    return __float_as_uint(r);
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return __uint_as_float(a) == __uint_as_float(b) ? 0xffffffffu : 0u;
  }
  static __device__ __forceinline__ uint32_t ge(uint32_t a, uint32_t b) {
    return __uint_as_float(a) >= __uint_as_float(b) ? 0xffffffffu : 0u;
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __uint_as_float(a) > __uint_as_float(b) ? 0xffffffffu : 0u;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
  static __device__ __forceinline__ uint32_t splat(int k) {
    return __float_as_uint(static_cast<float>(k));
  }
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 2;
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V v(uint32_t a) {
    return *reinterpret_cast<V*>(&a);
  }
  static __device__ __forceinline__ uint32_t u(V a) {
    return *reinterpret_cast<uint32_t*>(&a);
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return u(__hmax2_nan(v(a), v(b)));
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return __heq2_mask(v(a), v(b));
  }
  static __device__ __forceinline__ uint32_t ge(uint32_t a, uint32_t b) {
    return __hge2_mask(v(a), v(b));
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __hgt2_mask(v(a), v(b));
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return u(__hadd2(v(a), v(b)));
  }
  static __device__ __forceinline__ uint32_t splat(int k) {
    return u(__float2bfloat162_rn(static_cast<float>(k)));
  }
};
template <>
struct Lanes<__half> {
  static constexpr int N = 2;
  using V = __half2;
  static __device__ __forceinline__ V v(uint32_t a) {
    return *reinterpret_cast<V*>(&a);
  }
  static __device__ __forceinline__ uint32_t u(V a) {
    return *reinterpret_cast<uint32_t*>(&a);
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return u(__hmax2_nan(v(a), v(b)));
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return __heq2_mask(v(a), v(b));
  }
  static __device__ __forceinline__ uint32_t ge(uint32_t a, uint32_t b) {
    return __hge2_mask(v(a), v(b));
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __hgt2_mask(v(a), v(b));
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return u(__hadd2(v(a), v(b)));
  }
  static __device__ __forceinline__ uint32_t splat(int k) {
    return u(__float2half2_rn(static_cast<float>(k)));
  }
};

// The lanes of channels c .. c + N - 1 at pixel e of a staged array: NHWC
// [pixel][cb], NCHW [cb][pixel].
template <typename T, bool NHWC>
__device__ __forceinline__ uint32_t load(const T* s, int e, int c, int cb,
                                         int npix) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(s[NHWC ? e * cb + c : c * npix + e]);
  } else if constexpr (NHWC) {
    return *reinterpret_cast<const uint32_t*>(s + e * cb + c);
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(s);
    return static_cast<uint32_t>(h[c * npix + e]) |
           static_cast<uint32_t>(h[(c + 1) * npix + e]) << 16;
  }
}

template <typename T, bool NHWC>
__device__ __forceinline__ void store(T* s, int e, int c, int cb, int npix,
                                      uint32_t val) {
  if constexpr (sizeof(T) == 4) {
    s[NHWC ? e * cb + c : c * npix + e] = __uint_as_float(val);
  } else if constexpr (NHWC) {
    *reinterpret_cast<uint32_t*>(s + e * cb + c) = val;
  } else {
    uint16_t* h = reinterpret_cast<uint16_t*>(s);
    h[c * npix + e] = static_cast<uint16_t>(val);
    h[(c + 1) * npix + e] = static_cast<uint16_t>(val >> 16);
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// rows x row_elems elements, global rows gstride apart, shared rows sstride
// apart.  to_shared: global -> shared through cp.async, 16 bytes a copy
// where every row start is 16-byte aligned on both sides (the caller
// commits and waits), else one element at a time; otherwise shared ->
// global with 16-byte stores where aligned.
template <typename T, bool to_shared>
__device__ __forceinline__ void copy_rows(T* smem, const T* gsrc, T* gdst,
                                          int rows, int row_elems,
                                          size_t gstride, int sstride,
                                          int tid, int nthreads) {
  const uintptr_t gbase = reinterpret_cast<uintptr_t>(to_shared ? gsrc : gdst);
  const bool vec = (size_t(row_elems) * sizeof(T)) % 16 == 0 &&
                   (gstride * sizeof(T)) % 16 == 0 &&
                   (size_t(sstride) * sizeof(T)) % 16 == 0 && gbase % 16 == 0;
  if (vec) {
    const int per_row = row_elems * int(sizeof(T)) / 16;
    for (int k = tid; k < rows * per_row; k += nthreads) {
      const int r = k / per_row, q = k - r * per_row;
      char* s = reinterpret_cast<char*>(smem + size_t(r) * sstride) + q * 16;
      if constexpr (to_shared) {
        __pipeline_memcpy_async(
            s, reinterpret_cast<const char*>(gsrc + r * gstride) + q * 16, 16);
      } else {
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(gdst + r * gstride) +
                                  q * 16) = *reinterpret_cast<const uint4*>(s);
      }
    }
  } else {
    for (int k = tid; k < rows * row_elems; k += nthreads) {
      const int r = k / row_elems, q = k - r * row_elems;
      if constexpr (to_shared)
        smem[size_t(r) * sstride + q] = gsrc[r * gstride + q];
      else
        gdst[r * gstride + q] = smem[size_t(r) * sstride + q];
    }
  }
}

// One image's chunk of cv valid channels (c0 .. c0 + cv - 1), staged as cb
// lanes.  WH, WW: the window, 0 for one read at run time.
template <typename T, bool XNHWC, bool GNHWC, int WH, int WW>
__global__ void __launch_bounds__(kMaxThreads)
    pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int chans, int h, int w, int wh_rt,
                    int ww_rt, int cb) {
  using L = Lanes<T>;
  constexpr int MH = WH ? WH : kMaxWindow;
  constexpr int MW = WW ? WW : kMaxWindow;
  const int wh = WH ? WH : wh_rt, ww = WW ? WW : ww_rt;
  const int oh = h - wh + 1, ow = w - ww + 1;
  const int hw = h * w, ohw = oh * ow;
  const int chunks = (chans + cb - 1) / cb;
  const int img = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - img * chunks) * cb;
  const int cv = min(cb, chans - c0);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // x, then dx
  T* gs = reinterpret_cast<T*>(smem + align16(size_t(hw) * cb * sizeof(T)));
  T* cs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(gs) +
                               align16(size_t(ohw) * cb * sizeof(T)));

  // global offsets of the chunk: NHWC, a row of cv channels a pixel, C
  // apart; NCHW, one run of cv planes
  const size_t xoff = XNHWC ? size_t(img) * hw * chans + c0
                            : (size_t(img) * chans + c0) * hw;
  const size_t goff = GNHWC ? size_t(img) * ohw * chans + c0
                            : (size_t(img) * chans + c0) * ohw;
  if constexpr (XNHWC)
    copy_rows<T, true>(xs, x + xoff, nullptr, hw, cv, chans, cb, tid,
                       nthreads);
  else
    copy_rows<T, true>(xs, x + xoff, nullptr, 1, cv * hw, 0, 0, tid,
                       nthreads);
  if constexpr (GNHWC)
    copy_rows<T, true>(gs, g + goff, nullptr, ohw, cv, chans, cb, tid,
                       nthreads);
  else
    copy_rows<T, true>(gs, g + goff, nullptr, 1, cv * ohw, 0, 0, tid,
                       nthreads);
  __pipeline_commit();

  const int groups = cb / L::N;
  const uint32_t neg1 = L::splat(-1);
  // the lanes' constants: column k; for ring row r of the winner pass the
  // slot of its first column, (wh - 1 - r) * ww; slot (r, k) of the gather
  uint32_t colk[MW], rowoff[MH], slot[MH][MW];
#pragma unroll
  for (int k = 0; k < MW; ++k) colk[k] = L::splat(k);
#pragma unroll
  for (int r = 0; r < MH; ++r) {
    rowoff[r] = L::splat((wh - 1 - r) * ww);
#pragma unroll
    for (int k = 0; k < MW; ++k) slot[r][k] = L::splat(r * ww + k);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // Winners: thread (output column oj, lane group) walks the rows.  Row
  // entry: its max over the window's columns and the first column holding
  // it; ring[0] is the newest row, the window's bottom one.
  for (int item = tid; item < ow * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / ow;
    const int oj = XNHWC ? item / groups : item % ow;
    const int c = p * L::N;
    uint32_t rmax[MH], rcol[MH];
#pragma unroll
    for (int r = 0; r < MH; ++r) rmax[r] = rcol[r] = 0u;
    for (int i = 0; i < h; ++i) {
      uint32_t xv[MW];
#pragma unroll
      for (int k = 0; k < MW; ++k)
        xv[k] = k < ww ? load<T, XNHWC>(xs, i * w + oj + k, c, cb, hw) : 0u;
      uint32_t m = xv[0];
#pragma unroll
      for (int k = 1; k < MW; ++k)
        if (k < ww) m = L::max(m, xv[k]);
      uint32_t col = 0u;
#pragma unroll
      for (int k = MW - 1; k >= 0; --k) {
        if (k < ww) {
          const uint32_t e = L::eq(xv[k], m);
          col = (e & colk[k]) | (~e & col);
        }
      }
#pragma unroll
      for (int r = MH - 1; r >= 1; --r) {
        rmax[r] = rmax[r - 1];
        rcol[r] = rcol[r - 1];
      }
      rmax[0] = m;
      rcol[0] = col;
      if (i < wh - 1) continue;
      uint32_t wm = rmax[0];
#pragma unroll
      for (int r = 1; r < MH; ++r)
        if (r < wh) wm = L::max(wm, rmax[r]);
      // rows from the bottom (ring 0) to the top: the top-most match wins
      uint32_t code = neg1;
#pragma unroll
      for (int r = 0; r < MH; ++r) {
        if (r < wh) {
          const uint32_t e = L::eq(rmax[r], wm);
          code = (e & L::add(rcol[r], rowoff[r])) | (~e & code);
        }
      }
      store<T, XNHWC>(cs, (i - wh + 1) * ow + oj, c, cb, ohw, code);
    }
  }
  __syncthreads();

  // Gather: thread (input column j, lane group) walks the rows, keeping the
  // winning slots and g of the windows over its column, window row i - di
  // in ring[di]; dx(i, j) adds g of every window it won in slot order.
  for (int item = tid; item < w * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / w;
    const int j = XNHWC ? item / groups : item % w;
    const int c = p * L::N;
    uint32_t code[MH][MW], gv[MH][MW];
#pragma unroll
    for (int r = 0; r < MH; ++r)
#pragma unroll
      for (int k = 0; k < MW; ++k) {
        code[r][k] = neg1;
        gv[r][k] = 0u;
      }
    for (int i = 0; i < h; ++i) {
#pragma unroll
      for (int r = MH - 1; r >= 1; --r)
#pragma unroll
        for (int k = 0; k < MW; ++k) {
          code[r][k] = code[r - 1][k];
          gv[r][k] = gv[r - 1][k];
        }
#pragma unroll
      for (int k = 0; k < MW; ++k) {
        const int oj = j - k;
        const bool in = k < ww && i < oh && oj >= 0 && oj < ow;
        code[0][k] = in ? load<T, XNHWC>(cs, i * ow + oj, c, cb, ohw) : neg1;
        gv[0][k] = in ? load<T, GNHWC>(gs, i * ow + oj, c, cb, ohw) : 0u;
      }
      uint32_t acc = 0u;
#pragma unroll
      for (int r = 0; r < MH; ++r)
#pragma unroll
        for (int k = 0; k < MW; ++k)
          if (r < wh && k < ww) {
            const uint32_t e = L::eq(code[r][k], slot[r][k]);
            acc = L::add(acc, gv[r][k] & e);
          }
      store<T, XNHWC>(xs, i * w + j, c, cb, hw, acc);
    }
  }
  __syncthreads();

  if constexpr (XNHWC)
    copy_rows<T, false>(xs, nullptr, dx + xoff, hw, cv, chans, cb, tid,
                        nthreads);
  else
    copy_rows<T, false>(xs, nullptr, dx + xoff, 1, cv * hw, 0, 0, tid,
                        nthreads);
}

// One lane's bits: 16 in 16-bit dtypes, 32 in float32.
template <typename T>
using LaneBits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                           uint16_t>::type;

// Index of (position e, lane q = channel offset) in an array staged like
// x: NHWC [e][q], NCHW [q][e].  The wide body keeps its own arrays (row
// maxima, their columns, the windows' winners) in its x's layout, an index
// (a column or a pixel) in a lane's bits.
template <bool NHWC>
__device__ __forceinline__ int lane_at(int e, int q, int npix, int cb) {
  return NHWC ? e * cb + q : q * npix + e;
}

// Shared memory of a block, cb elem bytes a position: x (then dx), g and
// the windows' winners (slots in the register body, pixels in the wide
// one), and where `rows`, the wide body's row maxima and their columns.
__host__ __device__ __forceinline__ size_t smem_bytes(int h, int w, int oh,
                                                      int ow, int cb,
                                                      size_t elem,
                                                      bool rows) {
  const size_t at = size_t(cb) * elem;
  return align16(size_t(h) * w * at) + 2 * align16(size_t(oh) * ow * at) +
         (rows ? 2 * size_t(h) * ow * at : 0);
}

// Any window (the body above takes up to kMaxWindow a side): the same
// staging, then a separable winner search and a gather window row by
// window row.  Where the row arrays do not fit beside the plane at any
// chunk (see plan_chunk), the launch took a chunk for x, g and the winners
// alone, and the column pass reads each window whole: the same winners.
//
// The order: a NaN counts as greater than every number (max.NaN carries it
// into a window's max) and equal values as one, ties to the first; a
// window holding a NaN has its cotangent set to +0, so whatever it names
// adds nothing, as the plain version's NaN window routes nothing.
// - Row pass: for every row i and output column oj, the max of x[i][oj, oj
//   + ww) and the column of its first maximum, by prefix and suffix maxima
//   over blocks of ww columns (van Herk / Gil-Werman: a window is the
//   suffix of one block and the prefix of the next), a few operations an
//   element whatever the window.
// - Column pass: window (oi, oj)'s max is the max of its rows' maxima, and
//   its winning row the first of them holding it; at that row's column
//   lies its winner, the first raster-order maximum (XLA's
//   select_and_scatter rule), kept as a pixel index.
// - Gather: the windows of one window row that a pixel won are adjacent
//   (a window between two won by P lies inside their union and holds P,
//   so P is its first maximum too).  Window rows from the bottom, one a
//   step: the rightmost window of each run of equal winners adds the run's
//   cotangents, right to left, into its pixel's dx (which starts at 0):
//   oi descending, then oj descending, the plain version's slot order,
//   each add rounded in x's dtype.  One thread a lane and window; a run
//   is read four windows at a time, so that its loads overlap.
template <typename T, bool XNHWC, bool GNHWC>
__global__ void __launch_bounds__(kWideThreads)
    pool_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, int chans, int h, int w, int wh,
                         int ww, int cb) {
  using L = Lanes<T>;
  using B = LaneBits<T>;
  const int oh = h - wh + 1, ow = w - ww + 1;
  const int hw = h * w, ohw = oh * ow, how = h * ow;
  const int chunks = (chans + cb - 1) / cb;
  const int img = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - img * chunks) * cb;
  const int cv = min(cb, chans - c0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int groups = cb / L::N;
  // the separable search: its row arrays fit beside the plane at this
  // chunk (plan_chunk took it wherever they fit at some chunk, and a
  // smaller chunk only where they fit at none)
  const bool rows = smem_bytes(h, w, oh, ow, cb, sizeof(T), true) <= kSmemMax;
  // an index in each lane of a word
  const auto splat = [](int k) -> uint32_t {
    return sizeof(T) == 4 ? static_cast<uint32_t>(k)
                          : (static_cast<uint32_t>(k) & 0xffffu) * 0x10001u;
  };

  // x (then dx), g, the windows' winners [ohw], the row maxima [h ow] and
  // their columns [h ow], each cb lanes a position in x's layout
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t at = size_t(cb) * sizeof(T);
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + align16(size_t(hw) * at));
  T* wpix = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(gs) +
                                 align16(size_t(ohw) * at));
  T* rmax = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(wpix) +
                                 align16(size_t(ohw) * at));
  T* rcol = rmax + size_t(how) * cb;
  const B* rc_l = reinterpret_cast<const B*>(rcol);
  const size_t xoff = XNHWC ? size_t(img) * hw * chans + c0
                            : (size_t(img) * chans + c0) * hw;
  const size_t goff = GNHWC ? size_t(img) * ohw * chans + c0
                            : (size_t(img) * chans + c0) * ohw;
  if constexpr (XNHWC)
    copy_rows<T, true>(xs, x + xoff, nullptr, hw, cv, chans, cb, tid,
                       nthreads);
  else
    copy_rows<T, true>(xs, x + xoff, nullptr, 1, cv * hw, 0, 0, tid,
                       nthreads);
  if constexpr (GNHWC)
    copy_rows<T, true>(gs, g + goff, nullptr, ohw, cv, chans, cb, tid,
                       nthreads);
  else
    copy_rows<T, true>(gs, g + goff, nullptr, 1, cv * ohw, 0, 0, tid,
                       nthreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Row pass.  Unit (row i, block b, lane group p) takes output columns
  // [o0, o1), o0 = b ww: the suffix maxima of columns [o0, o0 + ww) right
  // to left (stored at the outputs), then the prefix maxima of the next
  // block's columns left to right, each output the max of its suffix and
  // its prefix (the suffix's on a tie: it lies left).  Output o0's window
  // is its block alone.
  const int nb = (ow + ww - 1) / ww;
  const int row_items = rows ? h * nb * groups : 0;
  for (int item = tid; item < row_items; item += nthreads) {
    const int p = XNHWC ? item % groups : item / (h * nb);
    const int u = XNHWC ? item / groups : item - p * (h * nb);
    const int i = u / nb, o0 = (u - i * nb) * ww;
    const int o1 = min(o0 + ww, ow), c = p * L::N;
    int k = o0 + ww - 1;
    uint32_t s = load<T, XNHWC>(xs, i * w + k, c, cb, hw);
    uint32_t sc = splat(k);
    for (;;) {
      if (k < o1 && k > o0) {
        store<T, XNHWC>(rmax, i * ow + k, c, cb, how, s);
        store<T, XNHWC>(rcol, i * ow + k, c, cb, how, sc);
      }
      if (--k < o0) break;
      const uint32_t v = load<T, XNHWC>(xs, i * w + k, c, cb, hw);
      const uint32_t take = L::ge(v, s) | ~L::eq(v, v);
      s = L::max(s, v);
      sc = (take & splat(k)) | (~take & sc);
    }
    store<T, XNHWC>(rmax, i * ow + o0, c, cb, how, s);
    store<T, XNHWC>(rcol, i * ow + o0, c, cb, how, sc);
    uint32_t pm = 0u, pc = 0u;
    for (int o = o0 + 1; o < o1; ++o) {
      const int kk = o + ww - 1;   // the next block's column
      const uint32_t v = load<T, XNHWC>(xs, i * w + kk, c, cb, hw);
      const uint32_t take =
          o == o0 + 1 ? ~0u : L::gt(v, pm) | (~L::eq(v, v) & L::eq(pm, pm));
      pm = o == o0 + 1 ? v : L::max(pm, v);
      pc = (take & splat(kk)) | (~take & pc);
      const uint32_t sv = load<T, XNHWC>(rmax, i * ow + o, c, cb, how);
      const uint32_t left = L::ge(sv, pm) | ~L::eq(sv, sv);
      store<T, XNHWC>(rmax, i * ow + o, c, cb, how, L::max(sv, pm));
      store<T, XNHWC>(rcol, i * ow + o, c, cb, how,
                      (left & load<T, XNHWC>(rcol, i * ow + o, c, cb, how)) |
                          (~left & pc));
    }
  }
  __syncthreads();

  // Column pass: the window's winning row, top to bottom, a row replacing
  // the running one only where its max is greater, and in each lane its
  // winner, that row's column (without the row arrays: the window's pixels
  // in raster order, a pixel replacing the running one only where it is
  // greater); a NaN window's cotangent set to +0.  Then x is dead: dx
  // starts at 0 in its place.
  for (int item = tid; item < ohw * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / ohw;
    const int o = XNHWC ? item / groups : item - p * ohw;
    const int oi = o / ow, oj = o - oi * ow, c = p * L::N;
    uint32_t m, pix = 0u;
    if (rows) {
      m = load<T, XNHWC>(rmax, o, c, cb, how);
      uint32_t r = splat(oi);
      for (int di = 1; di < wh; ++di) {
        const uint32_t v =
            load<T, XNHWC>(rmax, (oi + di) * ow + oj, c, cb, how);
        const uint32_t take = L::gt(v, m) | (~L::eq(v, v) & L::eq(m, m));
        m = L::max(m, v);
        r = (take & splat(oi + di)) | (~take & r);
      }
#pragma unroll
      for (int l = 0; l < L::N; ++l) {
        const int rl =
            static_cast<int>(L::N == 1 ? r : (r >> (16 * l)) & 0xffffu);
        const int cl = rc_l[lane_at<XNHWC>(rl * ow + oj, c + l, how, cb)];
        pix |= static_cast<uint32_t>(rl * w + cl) << (16 * l);
      }
    } else {
      m = load<T, XNHWC>(xs, oi * w + oj, c, cb, hw);
      pix = splat(oi * w + oj);
      for (int di = 0; di < wh; ++di)
        for (int dj = di == 0 ? 1 : 0; dj < ww; ++dj) {
          const int e = (oi + di) * w + oj + dj;
          const uint32_t v = load<T, XNHWC>(xs, e, c, cb, hw);
          const uint32_t take = L::gt(v, m) | (~L::eq(v, v) & L::eq(m, m));
          m = L::max(m, v);
          pix = (take & splat(e)) | (~take & pix);
        }
    }
    store<T, XNHWC>(wpix, o, c, cb, ohw, pix);
    const uint32_t nan = ~L::eq(m, m);
    if (nan)
      store<T, GNHWC>(gs, o, c, cb, ohw,
                      load<T, GNHWC>(gs, o, c, cb, ohw) & ~nan);
  }
  if (!rows) __syncthreads();   // the direct search read x
  for (int i = tid; i < int(align16(size_t(hw) * at) / 16); i += nthreads)
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // Gather: thread (lane q, window column oj) of window row oi; a run's
  // rightmost window adds the run.
  const B* px_l = reinterpret_cast<const B*>(wpix);
  const B* g_l = reinterpret_cast<const B*>(gs);
  B* dx_l = reinterpret_cast<B*>(xs);
  for (int oi = oh - 1; oi >= 0; --oi) {
    for (int item = tid; item < ow * cb; item += nthreads) {
      const int q = XNHWC ? item % cb : item / ow;
      const int oj = XNHWC ? item / cb : item - q * ow;
      // the pixel that won window (oi, o) in lane q
      const auto winner = [&](int o) {
        return static_cast<int>(px_l[lane_at<XNHWC>(oi * ow + o, q, ohw, cb)]);
      };
      const int pix = winner(oj);
      if (oj + 1 < ow && winner(oj + 1) == pix) continue;
      const int e = lane_at<XNHWC>(pix, q, hw, cb);
      uint32_t acc = dx_l[e];
      bool run = true;
      for (int o = oj; run; o -= 4) {
        int pj[4];
        uint32_t gj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pj[u] = o - u >= 0 ? winner(o - u) : -1;
          gj[u] = o - u >= 0
                      ? g_l[lane_at<GNHWC>(oi * ow + o - u, q, ohw, cb)]
                      : 0u;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          run = run && pj[u] == pix;
          if (run) acc = L::add(acc, gj[u]);
        }
      }
      dx_l[e] = static_cast<B>(acc);
    }
    __syncthreads();
  }

  if constexpr (XNHWC)
    copy_rows<T, false>(xs, nullptr, dx + xoff, hw, cv, chans, cb, tid,
                        nthreads);
  else
    copy_rows<T, false>(xs, nullptr, dx + xoff, 1, cv * hw, 0, 0, tid,
                        nthreads);
}

// A block's chunk of channels (cb, a multiple of `lanes`) and its shared
// memory: kChunkBytes of channels (no more than c needs), halved until it
// fits.  The wide body takes its separable search (*rows) where the row
// arrays fit at some chunk, else the largest chunk that fits x, g and the
// winners alone.  False where not even one lane group fits.
bool plan_chunk(int c, int h, int w, int wh, int ww, int lanes, size_t elem,
                int* cb_out, size_t* smem_out, bool* rows_out) {
  const int oh = h - wh + 1, ow = w - ww + 1;
  const int need = (c + lanes - 1) / lanes * lanes;
  const bool wide = wh > kMaxWindow || ww > kMaxWindow;
  for (int pass = wide ? 0 : 1; pass < 2; ++pass) {
    const bool rows = pass == 0;
    int cb = int(kChunkBytes / elem);
    if (cb > need) cb = need;
    size_t smem = smem_bytes(h, w, oh, ow, cb, elem, rows);
    while (smem > kSmemMax && cb > lanes) {
      cb = (cb / 2 + lanes - 1) / lanes * lanes;
      smem = smem_bytes(h, w, oh, ow, cb, elem, rows);
    }
    if (smem <= kSmemMax) {
      *cb_out = cb;
      *smem_out = smem;
      *rows_out = rows;
      return true;
    }
  }
  return false;
}

template <typename T, bool XNHWC, bool GNHWC, int WH, int WW>
int launch_window(const void* x, const void* g, void* dx, int n, int c, int h,
                  int w, int wh, int ww, cudaStream_t stream) {
  constexpr int lanes = Lanes<T>::N;
  const bool wide = wh > kMaxWindow || ww > kMaxWindow;
  int cb = 0;
  size_t smem = 0;
  bool rows = false;
  if (!plan_chunk(c, h, w, wh, ww, lanes, sizeof(T), &cb, &smem, &rows))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wide ? pool_bwd_wide_kernel<T, XNHWC, GNHWC>
                     : pool_bwd_kernel<T, XNHWC, GNHWC, WH, WW>;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = long(n) * ((c + cb - 1) / cb);
  if (blocks > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (w * (cb / lanes) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (wide) threads = kWideThreads;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      c, h, w, wh, ww, cb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool XNHWC, bool GNHWC>
int launch_layout(const void* x, const void* g, void* dx, int n, int c, int h,
                  int w, int wh, int ww, cudaStream_t s) {
  if (wh == 3 && ww == 3)
    return launch_window<T, XNHWC, GNHWC, 3, 3>(x, g, dx, n, c, h, w, wh, ww,
                                                s);
  return launch_window<T, XNHWC, GNHWC, 0, 0>(x, g, dx, n, c, h, w, wh, ww,
                                              s);
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int n, int c, int h, int w,
           int wh, int ww, int x_nhwc, int g_nhwc, cudaStream_t s) {
  if (x_nhwc && g_nhwc)
    return launch_layout<T, true, true>(x, g, dx, n, c, h, w, wh, ww, s);
  if (x_nhwc)
    return launch_layout<T, true, false>(x, g, dx, n, c, h, w, wh, ww, s);
  if (g_nhwc)
    return launch_layout<T, false, true>(x, g, dx, n, c, h, w, wh, ww, s);
  return launch_layout<T, false, false>(x, g, dx, n, c, h, w, wh, ww, s);
}

}  // namespace

extern "C" {

// x, dx (n, c, h, w) and g (n, c, h - wh + 1, w - ww + 1) in the dtype
// (0 float32, 1 bfloat16, 2 float16), each dense in NCHW order or, where
// x_nhwc / g_nhwc is 1, in NHWC order (channels_last); dx takes x's
// layout.  Returns the cudaError_t of the launch (0 on success); never
// synchronises.
// A pixel index fits a 16-bit lane: a plane that fits shared memory at
// the least chunk (4 bytes a position) has fewer than 65536 pixels.
int pool_bwd_launch(const void* x, const void* g, void* dx, int n, int c,
                    int h, int w, int wh, int ww, int x_nhwc, int g_nhwc,
                    int dtype, void* stream) {
  if (n <= 0 || c <= 0 || wh < 1 || ww < 1 || wh > h || ww > w)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, g, dx, n, c, h, w, wh, ww, x_nhwc, g_nhwc, s);
    case 1:
      return launch<__nv_bfloat16>(x, g, dx, n, c, h, w, wh, ww, x_nhwc,
                                   g_nhwc, s);
    case 2:
      return launch<__half>(x, g, dx, n, c, h, w, wh, ww, x_nhwc, g_nhwc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The cut of a launch on c channels of an h x w plane at window (wh, ww)
// in the dtype (as pool_bwd_launch), into out[0 .. 3]: the body (1 wide),
// the wide body's separable search (1) or direct one (0), the chunk of
// channels a block and its shared memory bytes.  Returns a cudaError_t
// (cudaErrorInvalidValue where the launch would refuse the shape).
int pool_bwd_plan(int c, int h, int w, int wh, int ww, int dtype,
                  long long* out) {
  if (c <= 0 || wh < 1 || ww < 1 || wh > h || ww > w || dtype < 0 ||
      dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t elem = dtype == 0 ? 4 : 2;
  int cb = 0;
  size_t smem = 0;
  bool rows = false;
  if (!plan_chunk(c, h, w, wh, ww, dtype == 0 ? 1 : 2, elem, &cb, &smem,
                  &rows))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = wh > kMaxWindow || ww > kMaxWindow;
  out[1] = rows;
  out[2] = cb;
  out[3] = static_cast<long long>(smem);
  return 0;
}

const char* pool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
