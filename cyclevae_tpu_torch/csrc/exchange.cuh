// Exchange between blocks that run at once (a cooperative launch), shared by
// wavernn.cu (K4), gru_ar_bwd.cu (K3) and gru_ar.cu (K1, K2): spins that
// cannot hang the card;
// pushes into another block's shared memory inside a thread-block cluster,
// counted in bytes by the receiver's mbarrier; step-tagged 8-byte words and
// step counts across the grid.  sm_90a.

#pragma once

#include <cuda_runtime.h>

namespace gru {

// A wait of some 30 s (which a resident grid never needs) stops the kernel
// with an error instead of holding the card.
__device__ __forceinline__ void spin_guard(long long start) {
  if (clock64() - start > (1ll << 36)) __trap();
}

// ---- exchange inside a cluster: st.async into the owner's shared memory,
// counted in bytes by the owner's mbarrier (no cluster barrier, no fence) ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned remote(unsigned addr, int rank) {  // same offset in rank's block
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// the phase's one arrival, expecting `bytes` of st.async data
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long start = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done) spin_guard(start);
  } while (!done);
}
__device__ __forceinline__ void push4(unsigned dst, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push_key(unsigned dst, unsigned long long key, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(dst),
               "l"(key), "r"(bar)
               : "memory");
}

// ---- exchange across the grid: each float travels with its step tag in one
// 8-byte word, so a reader polls the data itself (no grid barrier, no fence) ----
__device__ __forceinline__ void store_tagged(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long w = ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ ulonglong2 load_tagged2(const unsigned long long* p) {
  ulonglong2 w;
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n" : "=l"(w.x), "=l"(w.y) : "l"(p) : "memory");
  return w;
}
__device__ __forceinline__ void add_count(unsigned* count) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
}
__device__ __forceinline__ void wait_count(const unsigned* count, unsigned target) {
  const long long start = clock64();
  unsigned v;
  for (;;) {
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
    if ((int)(v - target) >= 0) break;
    spin_guard(start);
  }
}
// the block's arrival at a step count, ordered after every write the block
// made before it (a __syncthreads() precedes it): release at gpu scope
__device__ __forceinline__ void arrive_release(unsigned* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
}
// wait until the count reaches target; what the arrivals released is then
// visible to this thread, and to its block after a __syncthreads()
__device__ __forceinline__ void wait_acquire(const unsigned* count, unsigned target) {
  const long long start = clock64();
  unsigned v;
  for (;;) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
    if ((int)(v - target) >= 0) break;
    spin_guard(start);
  }
}
__device__ __forceinline__ unsigned tag_of(unsigned long long w) { return (unsigned)(w >> 32); }
__device__ __forceinline__ float value_of(unsigned long long w) { return __uint_as_float((unsigned)w); }

}  // namespace gru
