// Thread block clusters (sm_90): the cluster's barrier, another block's
// shared memory and barriers signalled across blocks.  ddpm_sampler_wide.cu
// (partial sums of the hidden units; its ring's stages by bulk copies) and
// flash_attention_wide.cu (partial
// logits and probabilities of the forward's slices, partial S and dP and
// the backward's dS and P fragments) exchange their partials through them.

#pragma once

#include <stdint.h>

namespace {

// The cluster's barrier in two halves, so that work can go between them:
// this block's arrival (release), then the wait for every block's
// (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The whole barrier, release / acquire at cluster scope: every block's
// partial sums, written before it, are visible after it.
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// The address of `p` (in this block's shared memory) in block `rank`'s.
template <typename P>
__device__ __forceinline__ P* peer_shared(P* p, int rank) {
  P* out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return out;
}

// Memory barriers (mbarrier) that count bytes stored into this block's
// shared memory by the cluster's blocks (st.async): a block arms its
// barrier with the bytes a phase brings, the senders' stores complete them,
// and its threads wait for the phase, after which the bytes are visible.
__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   cta_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers just initialised visible to the cluster (before the
// cluster barrier that every block passes before using them).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival on its block's barrier, with the bytes the phase
// awaits.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          cta_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until this block's barrier has completed the phase of `parity`.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n@!done bra WAIT;\n}\n" ::"r"(cta_addr(bar)),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of `p` (in this block's shared memory) in
// block `rank`'s.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(cta_addr(p)), "r"(rank));
  return out;
}

// 16 (8, 4) bytes into a peer's shared memory at `dst`, completing as many
// bytes of the phase of its barrier `bar` (both peer_addr addresses).
__device__ __forceinline__ void st_async(uint32_t dst, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, uint2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "f"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, float2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from device memory at `src` into this block's
// shared memory at `dst` (both 16-byte aligned), completing as many bytes
// of the phase of this block's barrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(cta_addr(dst)),
      "l"(src), "r"(bytes), "r"(cta_addr(bar))
      : "memory");
}

// The block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

}  // namespace
