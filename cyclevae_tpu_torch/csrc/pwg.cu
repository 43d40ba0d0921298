// Parallel WaveGAN's gated residual layer for NVIDIA Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package has no PWG.  The published
// generator (arXiv:1910.11480; parallel_wavegan.v1.yaml) is 30 of these
// layers; models/pwg.py runs one launch a layer.  All float32, FMA only (no
// tensor cores: the port's float32 runs with TF32 off).  With x (B, R, n),
// c (B, A, n), skip (B, S, n) and the products packed by
// models/pwg.py pack_layers (w1 (Kp, G): rows k = j*R + i the tap j of
// channel i, then the A channels of c, then zero rows; w2 (G/2, R + S): the
// out and skip 1x1 convolutions side by side), for every sample t:
//   X[k]  = x[i][t + (j - 1) d] (0 outside [0, n)), c[k - 3R][t], or 0
//   a[o]  = sum_k w1[k][o] X[k] + b1[o]                  o < G
//   g[h]  = tanh(a[h]) * sigmoid(a[G/2 + h])             h < G/2
//   v[o]  = sum_h w2[h][o] g[h] + b2[o]                  o < R + S
//   x'[r] = (x[r][t] + v[r]) * sqrt(1/2),  skip[s] (+)= v[R + s]
// Each sum runs over k (or h) in order, its bias added after it, as
// ops/cuda_pwg.py pwg_layer_reference writes it.
//
// What bounds it on this card: operations.  A sample needs 2 (Kp G + G/2
// (R + S)) = 2 (246 x 128 + 64 x 128) = 79,360 FLOP at A = 54 and moves
// ~1.2 KB (x read and written, c read, skip read and written): ~64 FLOP a
// byte against the card's float32 ridge of 67e12 / 3.35e12 = 20.  So the
// design is a register-tiled float32 matrix product that keeps a, g and the
// products out of device memory:
//   * a block computes all G = 128 gate channels of a tile of 128 samples
//     (256 threads, each 8 channels x 8 samples in registers: channels ty*4
//     .. +3 and their sigmoid partners G/2 + ty*4 .. +3, samples tx*4 .. +3
//     and 64 + tx*4 .. +3), so the gate is computed where a is, in
//     registers, and only g (64 x 128) goes to shared memory;
//   * the K = 3R + A inputs stream through two shared stages of 16 rows of
//     w1 and 16 rows of X, the next stage's loads in registers while the
//     current one is summed (one barrier a stage); the three taps of x are
//     three row ranges of X, so a dilation of 512 costs what a dilation of 1
//     does;
//   * the out and skip products (w2, 32 KB) read g from shared memory in the
//     same thread tiling, and the epilogue adds the residual (re-read from
//     L2), scales it and accumulates skip in place: each block owns its
//     samples of skip, and x' is a new buffer (neighbouring blocks read x).
// Shared memory: two stages (2 x 16 KB, which w2 reuses) and g (32 KB): 64
// KB a block, two blocks an SM (the registers allow two).
#include <cuda_runtime.h>

namespace {

constexpr int kR = 64, kG = 128, kS = 64, kHalf = kG / 2;
constexpr int kTile = 128;                  // samples a block computes
constexpr int kChunk = 16;                  // rows of w1 and X a stage holds
constexpr int kThreads = 256;
constexpr int kStageFloats = kChunk * kG + kChunk * kTile;
constexpr int kSmemFloats = 2 * kStageFloats + kHalf * kTile;
static_assert(kHalf * (kR + kS) <= 2 * kStageFloats, "w2 fits in the two stages");
static_assert(kChunk * kTile == 8 * kThreads && kChunk * kG == 8 * kThreads,
              "a stage is 8 values of X and 8 of w1 a thread");

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(kThreads, 2)
pwg_layer_kernel(const float* __restrict__ x, float* __restrict__ x_out, float* __restrict__ skip,
                 const float* __restrict__ c, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, int n, int A, int Kp, int d, int first) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem + 2 * kStageFloats;      // g, [kHalf][kTile]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const float* xb = x + (size_t)b * kR * n;
  const float* cb = c + (size_t)b * A * n;

  // the loads of a stage: X rows lrow + 2e (e < 8) at sample lcol, and the
  // float4 columns q = e * 256 + tid (e < 2) of 16 w1 rows of 32 float4 each
  const int lcol = tid & (kTile - 1), lrow = tid >> 7;
  float xr[8];
  float4 wr[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + lrow + 2 * e;
      int t = t0 + lcol;
      const float* src = nullptr;
      if (k < 3 * kR) {
        const int j = k / kR;
        src = xb + (size_t)(k - j * kR) * n;
        t += (j - 1) * d;
      } else if (k - 3 * kR < A) {
        src = cb + (size_t)(k - 3 * kR) * n;
      }
      xr[e] = (src != nullptr && t >= 0 && t < n) ? __ldg(src + t) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = e * kThreads + tid;
      wr[e] = __ldg(reinterpret_cast<const float4*>(w1 + (size_t)(k0 + (q >> 5)) * kG) + (q & 31));
    }
  };
  auto store = [&](int s) {
    float* ws = smem + s * kStageFloats;
    float* xs = ws + kChunk * kG;
#pragma unroll
    for (int e = 0; e < 8; ++e) xs[(lrow + 2 * e) * kTile + lcol] = xr[e];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = e * kThreads + tid;
      reinterpret_cast<float4*>(ws + (q >> 5) * kG)[q & 31] = wr[e];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // a = w1^T X, over Kp / 16 stages
  const int nk = Kp / kChunk;
  load(0);
  store(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) load((kc + 1) * kChunk);
    const float* ws = smem + s * kStageFloats;
    const float* xs = ws + kChunk * kG;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 wa = *reinterpret_cast<const float4*>(ws + kk * kG + ty * 4);
      const float4 wb = *reinterpret_cast<const float4*>(ws + kk * kG + kHalf + ty * 4);
      const float4 xa = *reinterpret_cast<const float4*>(xs + kk * kTile + tx * 4);
      const float4 xc = *reinterpret_cast<const float4*>(xs + kk * kTile + kTile / 2 + tx * 4);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
    if (kc + 1 < nk) store(s ^ 1);
    __syncthreads();
  }

  // the gate, in registers; g to shared memory
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = ty * 4 + i;
    const float bt = __ldg(b1 + h), bs = __ldg(b1 + kHalf + h);
    float gv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) gv[j] = tanhf(acc[i][j] + bt) * sigmoidf(acc[4 + i][j] + bs);
    *reinterpret_cast<float4*>(gs + h * kTile + tx * 4) = make_float4(gv[0], gv[1], gv[2], gv[3]);
    *reinterpret_cast<float4*>(gs + h * kTile + kTile / 2 + tx * 4) =
        make_float4(gv[4], gv[5], gv[6], gv[7]);
  }
  // w2 into the stages (every thread is past its last read of them)
  float* w2s = smem;
#pragma unroll
  for (int e = 0; e < kHalf * (kR + kS) / 4 / kThreads; ++e) {
    const int q = e * kThreads + tid;
    reinterpret_cast<float4*>(w2s)[q] = __ldg(reinterpret_cast<const float4*>(w2) + q);
  }
  __syncthreads();

  // v = w2^T g: rows ty*4 .. +3 of out (i < 4) and of skip (i >= 4)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int h = 0; h < kHalf; ++h) {
    const float4 wa = *reinterpret_cast<const float4*>(w2s + h * (kR + kS) + ty * 4);
    const float4 wb = *reinterpret_cast<const float4*>(w2s + h * (kR + kS) + kR + ty * 4);
    const float4 ga = *reinterpret_cast<const float4*>(gs + h * kTile + tx * 4);
    const float4 gc = *reinterpret_cast<const float4*>(gs + h * kTile + kTile / 2 + tx * 4);
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], gv[j], acc[i][j]);
  }

  // the residual and the skip sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float bo = __ldg(b2 + r), bk = __ldg(b2 + kR + r);
    const size_t xo = ((size_t)b * kR + r) * n;
    const size_t so = ((size_t)b * kS + r) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + (j < 4 ? tx * 4 + j : kTile / 2 + tx * 4 + j - 4);
      if (t < n) {
        x_out[xo + t] = (x[xo + t] + (acc[i][j] + bo)) * 0.70710678118654752f;
        const float v = acc[4 + i][j] + bk;
        skip[so + t] = first ? v : skip[so + t] + v;
      }
    }
  }
}

}  // namespace

extern "C" {

// One layer: x, x_out, skip (B, 64, n); c (B, A, n); w1 (Kp, 128) and w2
// (64, 128) 16-byte aligned; b1, b2 (128,).  first: skip is written, not
// read.  Grid (ceil(n / 128), B), 256 threads, 64 KB of shared memory.
int pwg_layer_f32(const void* x, void* x_out, void* skip, const void* c, const void* w1,
                  const void* b1, const void* w2, const void* b2, int B, int n, int A, int Kp,
                  int d, int first, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || A < 0 || Kp % kChunk || 3 * kR + A > Kp || d < 1)
    return cudaErrorInvalidValue;
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pwg_layer_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTile - 1) / kTile, B);
  pwg_layer_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(x_out), static_cast<float*>(skip),
      static_cast<const float*>(c), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), n, A, Kp, d, first);
  return cudaGetLastError();
}

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
