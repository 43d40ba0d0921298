// WaveRNN autoregressive sampling for NVIDIA Hopper, sm_90a (K4).
//
// Replaces the Pallas TPU kernel cyclevae_tpu/ops/pallas_wavernn.py:_kernel
// (wrapper pallas_wavernn_generate).  All float32.  Per step t, for the
// batch rows b (h = 0 and idx = K/2 before step 0):
//   gx  = cond_gates[b, t] + emb_tab[idx]            (a row gather; cond_gates
//                                                     and emb_tab come from the
//                                                     wrapper, b_ih included)
//   gh  = h . Whh^T + b_hh                           (Whh (3H, H), torch gate rows [r, z, n])
//   r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z), n = tanh(gx_n + r * gh_n)
//   h   = (1 - z) * n + z * h
//   logits = relu(h . W1^T + b1) . W2^T + b2         (W1 (FC, H), W2 (K, FC))
//   scores = logits / max(temp, 1e-6) + g            (temp > 0; g Gumbel, below)
//          = logits                                  (temp <= 0)
//   idx = argmax(scores), ties to the lowest index; out[b, t] = idx, fed back.
// The Gumbel noise is g = -log(-log(u + 1e-9) + 1e-9), u = (bits & 0x7fffff) *
// 2^-23, as in the TPU kernel, but the bits come from Philox4x32-10 written
// below (the TPU's on-chip generator has no CUDA counterpart): key (seed, 0),
// counter (t, b, k/4, 0), word k%4 for class k.  ops/cuda_wavernn.py computes
// the same words in torch, so the plain version draws the same uniforms.
//
// What bounds it on this card: not bytes and not FLOPs.  A 4.5 s utterance
// (T = 99,225 samples at 22.05 kHz, B = 1, H = 896, K = 256, FC = 128) does
// ~0.5 TFLOP (7.6 ms at the float32 FMA peak) and streams ~1.1 GB of
// conditioning gates (0.3 ms), but every sample depends on the one before, so
// the time is T times the latency of one step.  K1's layout (csrc/gru_ar.cu)
// keeps that chain short, and K4 takes it over:
//   * ONE cooperative launch runs the whole time loop; the weights are read
//     from device memory once.
//   * Block k owns hidden units [k*U, k*U+U) (U = 8, 112 blocks at H = 896).
//     Each warp holds its unit's three Whh rows in registers for the whole
//     call (H <= 1024); the block's U columns of W1 and the whole W2 (as
//     W2^T, 128 KB at K = 256, FC = 128) sit in shared memory.
//   * Per step a block computes its units' h_t and its partial of
//     f = h_t . W1^T over its units, writes both to double-buffered global
//     scratch, and meets the grid at ONE barrier.  After it, every block
//     copies the whole h_t and the G partials of f (cp.async, all in flight),
//     sums the partials in a fixed order (gru::sum_partials), and computes
//     relu, the logits, the same Philox words and the same argmax.  So every
//     block knows the next sample without a second barrier, and it is the
//     same sample in every block because every block sums in the same order
//     and draws the same counters: no atomics on the path.  Block 0 writes
//     out[b, t].
//   * The gather: each unit's finishing lanes read their three gate columns
//     of cond_gates (device memory, streamed) and of emb_tab[idx] (256 x 3H,
//     2.75 MB, L2-resident) right after the sample is known; the loads are
//     in flight during the Whh dot products.
//   * Offsets into cond_gates and out are size_t: B * T * 3H passes 2^31
//     from B = 9 at T = 99,225.
// No tensor cores and no TF32: B is 1-8 and the weights stay float32.
// Measured on an H100 (ops/wavernn_phases.py, B = 1, 8.1 us per step): the
// copy and sum of the fc1 partials, the logits with noise and warp argmax,
// and the gate phase (whose gathered loads wait on the sample) take about a
// quarter of the step each, the grid barrier an eighth.
//
// Built with -DWAVERNN_PROFILE, thread 0 of block 0 sums the SM cycles each
// phase of a step takes (wavernn_profile_read; ops/wavernn_phases.py prints
// them): 0 copy h and the fc1 partials and sum f, 1 logits, Gumbel noise and
// each warp's argmax, 2 the block's argmax, 3 gate-row dot products, gates
// and h_t, 4 wait for the block's other warps, 5 fc1 partial, 6 grid barrier.

#include <algorithm>
#include <climits>

#include <cooperative_groups.h>
#include <math_constants.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru;

struct Args {
  const float* gates;  // (B, T, 3H) conditioning gates, b_ih included
  const float* emb;    // (K, 3H)    embed gate table
  const float* whh;    // (3H, H)
  const float* bhh;    // (3H)
  const float* w1;     // (FC, H)
  const float* b1;     // (FC)
  const float* w2;     // (K, FC)
  const float* b2;     // (K)
  int* out;            // (B, T)
  float* hbuf;         // (2, B, Hs) scratch: h_t, rows padded to Hs = 4k >= H with zeros
  float* fpart;        // (2, G, BFs) scratch: block k's partial of f at [k]
  unsigned seed;
  float temp;
  int B, T, H, K, FC, U;
  int Hs, BFs;         // padded row lengths (multiples of 4 floats = 16 bytes)
  int stage_rows;      // f values (multiple of 4) summed per pass through smem
};

#ifdef WAVERNN_PROFILE
__device__ unsigned long long g_prof[7];
#define PROF_MARK(i)                                            \
  do {                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
      const long long now = clock64();                          \
      g_prof[i] += now - prof_t;                                \
      prof_t = now;                                             \
    }                                                           \
  } while (0)
#else
#define PROF_MARK(i) \
  do {               \
  } while (0)
#endif

// ---- Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11) ----
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ unsigned word(uint4 r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// Gumbel noise from 23 random bits, as the TPU kernel forms it
__device__ __forceinline__ float gumbel(unsigned bits) {
  const float u = (float)(bits & 0x7fffffu) * (1.0f / 8388608.0f);
  return -logf(-logf(u + 1e-9f) + 1e-9f);
}

// (value, index) argmax step as jnp.argmax and torch.argmax take it: the
// larger value, on a tie the lower index, and NaN above every number
__device__ __forceinline__ void arg_max(float& v, int& i, float ov, int oi) {
  const bool better = isnan(ov) ? (!isnan(v) || oi < i) : (ov > v || (ov == v && oi < i));
  if (better) {
    v = ov;
    i = oi;
  }
}

struct Smem {  // offsets in floats; every array starts on 16 bytes
  size_t h, stage, f, hown, bhh, w1, b1, w2t, b2, bestv, besti, idx, total_bytes;
};

__host__ __device__ inline Smem smem_layout(int B, int H, int K, int FC, int U, int G,
                                            int stage_rows) {
  Smem s;
  s.h = 0;                                          // B*Hs     h_{t-1}
  s.stage = s.h + (size_t)B * up4(H);               // G*rows   f partials, k-major
  s.f = s.stage + (size_t)G * stage_rows;           // B*FC     relu(h W1^T + b1)
  s.hown = s.f + up4((size_t)B * FC);               // B*U      own units' h (the carry)
  s.bhh = s.hown + up4((size_t)B * U);              // 3U       own rows of b_hh
  s.w1 = s.bhh + up4(3 * (size_t)U);                // U*FC     [u][c] = W1[c][j0+u]
  s.b1 = s.w1 + up4((size_t)U * FC);                // FC
  s.w2t = s.b1 + up4(FC);                           // FC*K     [c][k] = W2[k][c]
  s.b2 = s.w2t + up4((size_t)FC * K);               // K
  s.bestv = s.b2 + up4(K);                          // B*kWarps each warp's best score
  s.besti = s.bestv + up4((size_t)B * kWarps);      // B*kWarps ... and its class (int)
  s.idx = s.besti + up4((size_t)B * kWarps);        // B        the fed-back sample (int)
  s.total_bytes = (s.idx + up4(B)) * sizeof(float);
  return s;
}

// Logits, noise and per-warp argmax of R batch rows [b0, b0+R): thread k
// takes classes k, k+256, ... (in increasing order, so a tie keeps the lower)
template <int R>
__device__ void score_rows(const Args& a, const float* f_s, const float* w2t_s, const float* b2_s,
                           float* bestv, int* besti, int b0, int tt) {
  const int K = a.K, FC = a.FC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool sampled = a.temp > 0.f;
  const float tdiv = fmaxf(a.temp, 1e-6f);
  float bv[R];
  int bi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bv[r] = -CUDART_INF_F;
    bi[r] = INT_MAX;
  }
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float acc[R] = {};
    for (int c = 0; c < FC; ++c) {
      const float w = w2t_s[(size_t)c * K + k];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(f_s[(b0 + r) * FC + c], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = acc[r] + b2_s[k];
      if (sampled) {
        const uint4 bits = philox4x32_10(make_uint4((unsigned)tt, (unsigned)(b0 + r), (unsigned)k >> 2, 0u),
                                         a.seed, 0u);
        s = s / tdiv + gumbel(word(bits, k & 3));
      }
      arg_max(bv[r], bi[r], s, k);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      arg_max(bv[r], bi[r], __shfl_xor_sync(0xffffffffu, bv[r], off),
              __shfl_xor_sync(0xffffffffu, bi[r], off));
    if (lane == 0) {
      bestv[(b0 + r) * kWarps + warp] = bv[r];
      besti[(b0 + r) * kWarps + warp] = bi[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads) wavernn_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, K = a.K, FC = a.FC, U = a.U, Hs = a.Hs;
  const size_t H3 = 3 * (size_t)H;
  const int G = gridDim.x, k = blockIdx.x, j0 = k * U;
  const int nu = max(0, min(U, H - j0));  // units this block owns (last block may be ragged)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Smem L = smem_layout(B, H, K, FC, U, G, a.stage_rows);

  float* h_s = smem + L.h;
  float* stage = smem + L.stage;
  float* f_s = smem + L.f;
  float* hown_s = smem + L.hown;
  float* bhh_s = smem + L.bhh;
  float* w1_s = smem + L.w1;
  float* b1_s = smem + L.b1;
  float* w2t_s = smem + L.w2t;
  float* b2_s = smem + L.b2;
  float* bestv = smem + L.bestv;
  int* besti = reinterpret_cast<int*>(smem + L.besti);
  int* idx_s = reinterpret_cast<int*>(smem + L.idx);

  // ---- weights into registers and shared memory, once per call ----
  float4 wreg[3][kRegIters];  // Whh rows g*H + j0 + warp, float4 it at 128*it + 4*lane
  if (warp < nu) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int it = 0; it < kRegIters; ++it) {
        const int i = 128 * it + 4 * lane;
        const float* row = a.whh + (size_t)(g * H + j0 + warp) * H;
        wreg[g][it] = make_float4(i < H ? row[i] : 0.f, i + 1 < H ? row[i + 1] : 0.f,
                                  i + 2 < H ? row[i + 2] : 0.f, i + 3 < H ? row[i + 3] : 0.f);
      }
    }
  }
  for (int idx = threadIdx.x; idx < U * FC; idx += kThreads) {
    const int u = idx / FC, c = idx % FC;
    w1_s[idx] = u < nu ? a.w1[(size_t)c * H + j0 + u] : 0.f;
  }
  for (int idx = threadIdx.x; idx < FC * K; idx += kThreads) {
    const int c = idx / K, kk = idx % K;
    w2t_s[idx] = a.w2[(size_t)kk * FC + c];
  }
  for (int c = threadIdx.x; c < FC; c += kThreads) b1_s[c] = a.b1[c];
  for (int kk = threadIdx.x; kk < K; kk += kThreads) b2_s[kk] = a.b2[kk];
  for (int r = threadIdx.x; r < 3 * U; r += kThreads) {
    const int g = r / U, u = r % U;
    bhh_s[r] = u < nu ? a.bhh[g * H + j0 + u] : 0.f;
  }

#ifdef WAVERNN_PROFILE
  long long prof_t = clock64();
#endif
  // step t computes h_t; the sample of step t-1 is drawn at the top of step
  // t (from h_{t-1}); the pass with t == T only draws the last sample
  for (int t = 0; t <= T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t == T && k != 0) break;  // block 0 alone writes the last sample

    if (t == 0) {
      for (int idx = threadIdx.x; idx < B * Hs; idx += kThreads) h_s[idx] = 0.f;
      for (int idx = threadIdx.x; idx < B * U; idx += kThreads) hown_s[idx] = 0.f;
      for (int b = threadIdx.x; b < B; b += kThreads) idx_s[b] = K / 2;
      __syncthreads();
    } else {
      // ---- h_{t-1} into shared memory, f = relu(sum of the G partials + b1) ----
      if (t < T) {
        const float* src = a.hbuf + (size_t)cur * B * Hs;
        for (int q = threadIdx.x; q < B * Hs / 4; q += kThreads) cp_async16(h_s + 4 * q, src + 4 * q);
      }
      sum_partials(a.fpart + (size_t)cur * G * a.BFs, stage, G, B * FC, a.BFs, a.stage_rows,
                   [&](int idx, float s) { f_s[idx] = fmaxf(s + b1_s[idx % FC], 0.f); });
      PROF_MARK(0);

      // ---- the sample of step t-1: logits, noise, argmax over the block ----
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        const int R = min(kBatchChunk, B - b0);
        if (R == 4) score_rows<4>(a, f_s, w2t_s, b2_s, bestv, besti, b0, t - 1);
        else if (R == 3) score_rows<3>(a, f_s, w2t_s, b2_s, bestv, besti, b0, t - 1);
        else if (R == 2) score_rows<2>(a, f_s, w2t_s, b2_s, bestv, besti, b0, t - 1);
        else score_rows<1>(a, f_s, w2t_s, b2_s, bestv, besti, b0, t - 1);
      }
      PROF_MARK(1);
      __syncthreads();
      for (int b = threadIdx.x; b < B; b += kThreads) {
        float v = bestv[b * kWarps];
        int i = besti[b * kWarps];
        for (int w = 1; w < kWarps; ++w) arg_max(v, i, bestv[b * kWarps + w], besti[b * kWarps + w]);
        idx_s[b] = i;
        if (k == 0) a.out[(size_t)b * T + (t - 1)] = i;
      }
      __syncthreads();
      PROF_MARK(2);
      if (t == T) break;
    }

    // ---- a warp per own unit: its 3 gate rows, then its gates and h_t ----
    if (warp < nu) {
      const int u = warp, j = j0 + u;
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        const int bl = b0 + lane;  // the batch row that lanes 0-3 finish
        const bool finisher = lane < kBatchChunk && bl < B;
        float gxr = 0.f, gxz = 0.f, gxn = 0.f;
        if (finisher) {  // streamed gates + gathered table row: in flight during the dot products
          const float* cg_row = a.gates + ((size_t)bl * T + t) * H3 + j;
          const float* e_row = a.emb + (size_t)idx_s[bl] * H3 + j;
          gxr = cg_row[0] + e_row[0];
          gxz = cg_row[H] + e_row[H];
          gxn = cg_row[2 * H] + e_row[2 * H];
        }
        // rows past B repeat row B-1 and are dropped: branch-free, so the
        // compiler batches the loads instead of waiting out each one
        int row[kBatchChunk];
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) row[c] = min(b0 + c, B - 1);
        float sr[kBatchChunk] = {}, sz[kBatchChunk] = {}, sn[kBatchChunk] = {};
#pragma unroll
        for (int it = 0; it < kRegIters; ++it) {
          const int i = 128 * it + 4 * lane;
          if (i < H) {
#pragma unroll
            for (int c = 0; c < kBatchChunk; ++c) {
              const float4 v = *reinterpret_cast<const float4*>(h_s + (size_t)row[c] * Hs + i);
              sr[c] = dot4(wreg[0][it], v, sr[c]);
              sz[c] = dot4(wreg[1][it], v, sz[c]);
              sn[c] = dot4(wreg[2][it], v, sn[c]);
            }
          }
        }
        float tr = 0.f, tz = 0.f, tn = 0.f;
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) {  // butterfly: every lane gets every sum
          const float s0 = warp_sum(sr[c]), s1 = warp_sum(sz[c]), s2 = warp_sum(sn[c]);
          if (lane == c) {
            tr = s0;
            tz = s1;
            tn = s2;
          }
        }
        if (finisher) {
          const float rg = sigmoid_f(gxr + (tr + bhh_s[u]));
          const float zg = sigmoid_f(gxz + (tz + bhh_s[U + u]));
          const float ng = tanhf(gxn + rg * (tn + bhh_s[2 * U + u]));
          float* own = hown_s + bl * U + u;
          const float hnew = (1.f - zg) * ng + zg * *own;
          *own = hnew;
          __stcg(a.hbuf + (size_t)nxt * B * Hs + (size_t)bl * Hs + j, hnew);
        }
      }
    }
    PROF_MARK(3);
    __syncthreads();
    PROF_MARK(4);

    // ---- this block's partial of f = h_t . W1^T over its units ----
    float* part = a.fpart + ((size_t)nxt * G + k) * a.BFs;
    for (int idx = threadIdx.x; idx < B * FC; idx += kThreads) {
      const int b = idx / FC, c = idx % FC;
      float s = 0.f;
      for (int u = 0; u < nu; ++u) s = fmaf(hown_s[b * U + u], w1_s[u * FC + c], s);
      __stcg(part + idx, s);
    }
    PROF_MARK(5);
    grid.sync();
    PROF_MARK(6);
  }
}

int plan(int B, int H, int K, int FC, int* grid, int* units, int* stage_rows, int* smem) {
  if (B < 1 || H < 1 || K < 1 || FC < 1 || H > 128 * kRegIters) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e != cudaSuccess) return e;
  // U = 8: one warp per unit and every warp busy (more blocks would not
  // shorten the gate phase, only add partials to copy and sum); the f stage
  // takes what shared memory is left, up to all B*FC values
  const int U = std::min(kWarps, H), G = (H + U - 1) / U;
  const size_t base = smem_layout(B, H, K, FC, U, G, 0).total_bytes;
  const size_t row_bytes = (size_t)G * sizeof(float);
  if (base + 4 * row_bytes > (size_t)optin) return cudaErrorInvalidConfiguration;  // W2 or h too large
  const int rows = (int)std::min(up4((size_t)B * FC), (optin - base) / row_bytes / 4 * 4);
  const size_t s = smem_layout(B, H, K, FC, U, G, rows).total_bytes;
  bool fits = false;
  e = co_resident(wavernn_kernel, s, sms, G, &fits);
  if (e != cudaSuccess) return e;
  if (!fits) return cudaErrorCooperativeLaunchTooLarge;
  *grid = G;
  *units = U;
  *stage_rows = rows;
  *smem = (int)s;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// blocks, units per block, f-stage rows and dynamic shared bytes for one call
int wavernn_plan(int B, int H, int K, int FC, int* grid, int* units, int* stage_rows, int* smem) {
  return plan(B, H, K, FC, grid, units, stage_rows, smem);
}

// hbuf: (2, B, Hs) floats, zeroed (its padding is read); fpart: (2, grid,
// BFs) floats; Hs and BFs being H and B*FC rounded up to multiples of 4
int wavernn_generate_f32(const void* gates, const void* emb, const void* whh, const void* bhh,
                         const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                         void* hbuf, void* fpart, unsigned seed, float temp, int B, int T, int H,
                         int K, int FC, int grid, int units, int stage_rows, int smem,
                         void* stream) {
  if (B < 1 || T < 1 || H < 1 || K < 1 || FC < 1 || units < 1 || units > kWarps ||
      H > 128 * kRegIters || stage_rows < 4 || stage_rows % 4 || (long long)grid * units < H)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(gates), static_cast<const float*>(emb),
         static_cast<const float*>(whh),   static_cast<const float*>(bhh),
         static_cast<const float*>(w1),    static_cast<const float*>(b1),
         static_cast<const float*>(w2),    static_cast<const float*>(b2),
         static_cast<int*>(out),           static_cast<float*>(hbuf),
         static_cast<float*>(fpart),       seed,
         temp,                             B,
         T,                                H,
         K,                                FC,
         units,                            (int)up4(H),
         (int)up4((size_t)B * FC),         stage_rows};
  cudaError_t e = cudaFuncSetAttribute(wavernn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(wavernn_kernel), dim3(grid),
                                  dim3(kThreads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifdef WAVERNN_PROFILE
int wavernn_profile_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[7] = {};
  return cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
