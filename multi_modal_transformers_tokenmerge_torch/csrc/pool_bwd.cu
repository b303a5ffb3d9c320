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
// pool_bwd_wide_kernel, on the same staging: one thread a pixel and lane
// group, the window's values read from shared memory, its max then its
// first match in raster order found by two passes (the match's slot
// stored as an integer, 16 bits a lane), and each input pixel gathering g
// over the slots it may have won, in slot order, as the body above does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
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

// The winning slot of a window as an integer in each lane (16 bits a lane
// in 16-bit dtypes, 0xffff for none; 32 in float32, ~0 for none), and the
// lane mask of two codes' equal lanes.
template <typename T>
struct Slots {
  static __device__ __forceinline__ uint32_t splat(int k) {
    return (static_cast<uint32_t>(k) & 0xffffu) * 0x10001u;
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return __vcmpeq2(a, b);
  }
};
template <>
struct Slots<float> {
  static __device__ __forceinline__ uint32_t splat(int k) {
    return static_cast<uint32_t>(k);
  }
  static __device__ __forceinline__ uint32_t eq(uint32_t a, uint32_t b) {
    return a == b ? 0xffffffffu : 0u;
  }
};

// Any window (the body above takes up to kMaxWindow a side): the same
// staging, winners and gather, each window read from shared memory.
template <typename T, bool XNHWC, bool GNHWC>
__global__ void __launch_bounds__(kMaxThreads)
    pool_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, int chans, int h, int w, int wh,
                         int ww, int cb) {
  using L = Lanes<T>;
  using K = Slots<T>;
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

  const int groups = cb / L::N;
  const uint32_t none = K::splat(-1);
  // Winners: the window's max (max.NaN: a NaN window matches nothing), then
  // its first slot in raster order holding it.
  for (int item = tid; item < ohw * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / ohw;
    const int o = XNHWC ? item / groups : item % ohw;
    const int oi = o / ow, oj = o - oi * ow, c = p * L::N;
    uint32_t wm = load<T, XNHWC>(xs, oi * w + oj, c, cb, hw);
    for (int di = 0; di < wh; ++di)
      for (int dj = 0; dj < ww; ++dj)
        wm = L::max(wm, load<T, XNHWC>(xs, (oi + di) * w + oj + dj, c, cb,
                                       hw));
    uint32_t code = none;
    for (int slot = wh * ww - 1; slot >= 0; --slot) {
      const int di = slot / ww, dj = slot - di * ww;
      const uint32_t e =
          L::eq(load<T, XNHWC>(xs, (oi + di) * w + oj + dj, c, cb, hw), wm);
      code = (e & K::splat(slot)) | (~e & code);
    }
    store<T, XNHWC>(cs, o, c, cb, ohw, code);
  }
  __syncthreads();

  // Gather: dx(i, j) adds g of every window it won, in slot order.
  for (int item = tid; item < hw * groups; item += nthreads) {
    const int p = XNHWC ? item % groups : item / hw;
    const int e = XNHWC ? item / groups : item % hw;
    const int i = e / w, j = e - i * w, c = p * L::N;
    uint32_t acc = 0u;
    for (int di = 0; di < wh; ++di) {
      const int oi = i - di;
      if (oi < 0 || oi >= oh) continue;
      for (int dj = 0; dj < ww; ++dj) {
        const int oj = j - dj;
        if (oj < 0 || oj >= ow) continue;
        const uint32_t won = K::eq(load<T, XNHWC>(cs, oi * ow + oj, c, cb, ohw),
                                   K::splat(di * ww + dj));
        acc = L::add(acc, load<T, GNHWC>(gs, oi * ow + oj, c, cb, ohw) & won);
      }
    }
    // every thread has read its x values in the winner pass: dx may take
    // x's place
    store<T, XNHWC>(xs, e, c, cb, hw, acc);
  }
  __syncthreads();

  if constexpr (XNHWC)
    copy_rows<T, false>(xs, nullptr, dx + xoff, hw, cv, chans, cb, tid,
                        nthreads);
  else
    copy_rows<T, false>(xs, nullptr, dx + xoff, 1, cv * hw, 0, 0, tid,
                        nthreads);
}

size_t smem_bytes(int h, int w, int oh, int ow, int cb, size_t elem) {
  return align16(size_t(h) * w * cb * elem) +
         2 * align16(size_t(oh) * ow * cb * elem);
}

template <typename T, bool XNHWC, bool GNHWC, int WH, int WW>
int launch_window(const void* x, const void* g, void* dx, int n, int c, int h,
                  int w, int wh, int ww, cudaStream_t stream) {
  constexpr int lanes = Lanes<T>::N;
  const int oh = h - wh + 1, ow = w - ww + 1;
  int cb = kChunkBytes / int(sizeof(T));
  const int need = (c + lanes - 1) / lanes * lanes;
  if (cb > need) cb = need;
  size_t smem = smem_bytes(h, w, oh, ow, cb, sizeof(T));
  while (smem > kSmemMax && cb > lanes) {
    cb = (cb / 2 + lanes - 1) / lanes * lanes;
    smem = smem_bytes(h, w, oh, ow, cb, sizeof(T));
  }
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wh > kMaxWindow || ww > kMaxWindow
                    ? pool_bwd_wide_kernel<T, XNHWC, GNHWC>
                    : pool_bwd_kernel<T, XNHWC, GNHWC, WH, WW>;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = long(n) * ((c + cb - 1) / cb);
  if (blocks > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (w * (cb / lanes) + 31) / 32 * 32;
  if (wh > kMaxWindow || ww > kMaxWindow) threads = kMaxThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
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
int pool_bwd_launch(const void* x, const void* g, void* dx, int n, int c,
                    int h, int w, int wh, int ww, int x_nhwc, int g_nhwc,
                    int dtype, void* stream) {
  // a slot index and the none code fit a 16-bit lane
  if (n <= 0 || c <= 0 || wh < 1 || ww < 1 || wh > h || ww > w ||
      wh * ww >= 0xffff)
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

const char* pool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
