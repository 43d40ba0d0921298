// Device helpers shared by the AR-GRU kernels (gru_ar.cu: forward, with and
// without the training outputs; gru_ar_bwd.cu: the reverse-time cotangent
// scan).  Both build for sm_90a with a plain C interface (ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gru {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatchChunk = 4;  // batch rows one warp accumulates together
constexpr int kRegIters = 8;    // float4s of one Whh row a lane holds in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// a float stored at the weight type (round to nearest even, as astype does)
template <typename W> __device__ __forceinline__ W from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// value as the TPU kernels feed it to a product: rounded to the weight type
template <typename W> __device__ __forceinline__ float round_w(float x) { return to_f(from_f<W>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// four consecutive values as floats (16-byte float or 8-byte bf16 load)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float dot4(float4 w, float4 v, float acc) {
  return fmaf(w.w, v.w, fmaf(w.z, v.z, fmaf(w.y, v.y, fmaf(w.x, v.x, acc))));
}

// 16-byte asynchronous copy global -> shared, cached in L2 only
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline size_t up8(size_t n) { return (n + 7) / 8 * 8; }

// Up to H = 1024 (and one unit per warp), each warp keeps its unit's three
// Whh rows in registers, as float, for the whole call: the per-step dot
// products then read only h from shared memory.  Larger or odd H reads the
// rows from shared memory.
__host__ __device__ inline bool whh_in_regs(int H, int U) {
  return H % 4 == 0 && H <= 128 * kRegIters && U <= kWarps;
}

// Device facts a plan needs: SM count, opt-in shared memory per block, and
// whether cooperative launches are supported.
inline cudaError_t device_facts(int* sms, int* optin) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

// Whether G blocks of `kernel` with `smem` dynamic bytes are all resident
// at once (a cooperative launch refuses more).
template <typename K>
cudaError_t co_resident(K kernel, size_t smem, int sms, int G, bool* fits) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  *fits = (long long)occ * sms >= G;
  return cudaSuccess;
}

}  // namespace gru
