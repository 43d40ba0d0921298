// Fused autoregressive GRU forward for NVIDIA Hopper, sm_90a: inference (K1)
// and training (K2), one kernel body with a compile-time flag.
//
// Replaces the Pallas TPU kernels cyclevae_tpu/ops/pallas_gru.py:_kernel
// (wrapper pallas_gru_ar) and :_kernel_train (wrapper pallas_gru_ar_train).
// Per frame t, for the batch rows b:
//   gx  = gates_x[b, t] + y_{t-1} . Wy^T          (Wy = w_ih[:, conv_dim:], (3H, out))
//   gh  = h_{t-1} . Whh^T + b_hh                  (Whh (3H, H), torch gate rows [r, z, n])
//   r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z), n = tanh(gx_n + r * gh_n)
//   h_t = (1 - z) * n + z * h_{t-1}
//   o_t = h_t                                     (inference)
//   o_t = h_t * mask[b, t]                        (training: inverted dropout on the GRU
//                                                  output; h_seq[b, t] = h_t at W)
//   y_t = o_t . Wout^T + b_out                    (fed back as the next frame's y)
// The carried h stays unmasked and float in both modes.  The weights are
// float or bf16.  As in the TPU kernels, h, y and o_t are rounded to the
// weight type W before each product, products accumulate in float, both
// biases stay float, the gates, mask and h_seq stream at W and the carried h
// and y stay float.  No tensor cores: B is 2-10 on the main paths, and float
// weights must not be rounded to TF32.
//
// What bounds it on this card: not bytes and not FLOPs.  One call at H=1024,
// B=3, T=1120 moves ~35 MB and does ~22.5 GFLOP (0.34 ms at the float FMA
// peak), but every frame depends on the one before, so the time is T times
// the latency of one frame.  The design keeps that chain short:
//   * ONE cooperative launch runs the whole time loop (the TPU kernel's
//     sequential grid); the weights are read from device memory once.
//   * Block k owns hidden units [k*U, k*U+U) (U=8, 128 blocks, one per SM at
//     H=1024).  Up to H=1024 each warp holds its unit's three Whh rows in
//     registers, as float, for the whole call; the rows of Wy and the block's
//     U columns of Wout sit in shared memory.  Larger or odd H keeps the Whh
//     rows in shared memory instead.
//   * Per frame a block computes its units' h_t and its partial of y_t
//     (its U columns of Wout), writes both to double-buffered global
//     scratch, and meets the grid at ONE barrier.  After it, every block
//     copies the whole h_t and the G partials of y_t into shared memory and
//     sums the partials in a fixed order (deterministic), so y needs no
//     second barrier.  Frame t reads buffer t%2 and writes (t+1)%2: a block
//     that runs ahead into frame t+1 cannot overwrite what a slower block
//     still reads in frame t.
//   * Those copies are cp.async (16 bytes a thread, through L2, never the
//     SM's L1), all in flight at once: the frame pays one L2 round trip, not
//     one per element.  Partials sit k-major so the sums read shared memory
//     without bank conflicts.  h_t crosses blocks already rounded to the
//     weight type; each block keeps the float carry of its own units.
//   * One warp takes a unit's three gate rows for up to 4 batch rows at once,
//     branch-free so that the compiler batches the shared loads, and its
//     lanes 0-3 then finish the gates and h_t of that unit with no
//     block-wide sync between.  In training mode those lanes also read the
//     unit's mask value with the gates and write h_seq: no extra barrier and
//     no extra shared memory.
// Measured on an H100 (ops/gru_ar_phases.py), the copy of the partials is
// the largest phase: ~76 KB per block per frame, at the L2's bandwidth.
// The grid is sized from the occupancy query so that every block is resident
// (cooperative launch refuses more); any H works, with a ragged last block.
//
// Built with -DGRU_AR_PROFILE, thread 0 of block 0 sums the SM cycles each
// phase of a frame takes (gru_ar_profile_read; ops/gru_ar_phases.py prints
// them): 0 copy h and the y partials and sum y, 1 gate-row dot products,
// 2 their warp sums, 3 gates and h_t, 4 wait for the block's other warps,
// 5 y partial, 6 grid barrier.

#include <algorithm>

#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru;

struct Args {
  const void* gx;     // (B, T, 3H) weight type
  const void* wy;     // (3H, out)  weight type
  const void* whh;    // (3H, H)    weight type
  const float* bhh;   // (3H)
  const void* wout;   // (out, H)   weight type
  const float* bout;  // (out)
  const float* y0;    // (B, out)
  const float* h0;    // (B, H)
  const void* mask;   // (B, T, H)  weight type, training only
  float* trj;         // (B, T, out)
  float* y_last;      // (B, out)
  float* h_last;      // (B, H)
  void* hseq;         // (B, T, H)  weight type, training only
  float* hbuf;        // (2, B, Hs)     scratch: h_t rounded to W, rows padded to Hs = 4k >= H
  float* ypart;       // (2, G, BOs)    scratch, block k's partial of y at [k]
  int B, T, H, out, U;
  int Hs, BOs;        // padded row lengths (multiples of 4 floats = 16 bytes)
  int stage_rows;     // y rows (multiple of 4) summed per pass through smem
};

#ifdef GRU_AR_PROFILE
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

struct Smem {  // offsets in floats; every array starts on 16 bytes
  size_t h, stage, y, hn, hown, bhh, w, total_bytes;
};

__host__ __device__ inline Smem smem_layout(int B, int H, int out, int U, int G, int stage_rows,
                                            int wbytes) {
  const size_t R = 3 * (size_t)U;
  Smem s;
  s.h = 0;                                      // B*Hs     h_{t-1}, rounded to W
  s.stage = s.h + (size_t)B * up4(H);           // G*rows   y partials, k-major
  s.y = s.stage + (size_t)G * stage_rows;       // B*out    y_{t-1}, float
  s.hn = s.y + up4((size_t)B * out);            // B*U      own o_t, rounded to W
  s.hown = s.hn + up4((size_t)B * U);           // B*U      own h_t, float (the carry)
  s.bhh = s.hown + up4((size_t)B * U);          // 3U       own rows of b_hh
  s.w = s.bhh + up4(R);                         // [Whh 3U*H,] Wy 3U*out, Wout U*out
  const size_t whh = whh_in_regs(H, U) ? 0 : R * H;
  s.total_bytes = s.w * sizeof(float) + (whh + R * out + (size_t)U * out) * wbytes;
  return s;
}

// y_{t} = the G block partials summed in a fixed order, plus b_out; block 0
// also writes it to trj[:, t]
__device__ void reduce_y(const Args& a, const float* __restrict__ part, float* stage, float* y_s,
                         int G, int t, bool write_trj) {
  sum_partials(part, stage, G, a.B * a.out, a.BOs, a.stage_rows, [&](int idx, float s) {
    const int b = idx / a.out, o = idx % a.out;
    const float y = s + a.bout[o];
    y_s[idx] = y;
    if (write_trj) a.trj[((size_t)b * a.T + t) * a.out + o] = y;
  });
}

template <typename W, bool kTrain>
__global__ void __launch_bounds__(kThreads) gru_ar_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, OUT = a.out, U = a.U, Hs = a.Hs;
  const int G = gridDim.x, k = blockIdx.x, j0 = k * U;
  const int nu = max(0, min(U, H - j0));  // units this block owns (last block may be ragged)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Smem L = smem_layout(B, H, OUT, U, G, a.stage_rows, sizeof(W));
  const bool regs = whh_in_regs(H, U);

  float* h_s = smem + L.h;
  float* stage = smem + L.stage;
  float* y_s = smem + L.y;
  float* hn_s = smem + L.hn;
  float* hown_s = smem + L.hown;
  float* bhh_s = smem + L.bhh;
  W* whh_s = reinterpret_cast<W*>(smem + L.w);  // row g*U + u: gate g of unit j0+u
  W* wy_s = whh_s + (regs ? 0 : (size_t)3 * U * H);
  W* wout_s = wy_s + (size_t)3 * U * OUT;       // [u][o] = Wout[o][j0+u]

  const W* gx = static_cast<const W*>(a.gx);
  const W* wy = static_cast<const W*>(a.wy);
  const W* whh = static_cast<const W*>(a.whh);
  const W* wout = static_cast<const W*>(a.wout);
  const W* mask = static_cast<const W*>(a.mask);
  W* hseq = static_cast<W*>(a.hseq);

  // ---- weights into registers and shared memory, once per call ----
  float4 wreg[3][kRegIters];  // regs: Whh rows g*H + j0 + warp, float4 it at 128*it + 4*lane
  if (regs) {
    if (warp < nu) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int it = 0; it < kRegIters; ++it) {
          const int i = 128 * it + 4 * lane;
          wreg[g][it] = i < H ? load4(whh + (size_t)(g * H + j0 + warp) * H + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < 3 * U * H; idx += kThreads) {
      const int r = idx / H, i = idx % H, g = r / U, u = r % U;
      if (u < nu) whh_s[idx] = whh[(size_t)(g * H + j0 + u) * H + i];
    }
  }
  for (int idx = threadIdx.x; idx < 3 * U * OUT; idx += kThreads) {
    const int r = idx / OUT, o = idx % OUT, g = r / U, u = r % U;
    if (u < nu) wy_s[idx] = wy[(size_t)(g * H + j0 + u) * OUT + o];
  }
  for (int idx = threadIdx.x; idx < U * OUT; idx += kThreads) {
    const int u = idx / OUT, o = idx % OUT;
    if (u < nu) wout_s[idx] = wout[(size_t)o * H + j0 + u];
  }
  for (int r = threadIdx.x; r < 3 * U; r += kThreads) {
    const int g = r / U, u = r % U;
    bhh_s[r] = u < nu ? a.bhh[g * H + j0 + u] : 0.f;
  }

#ifdef GRU_AR_PROFILE
  long long prof_t = clock64();
#endif
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;

    // ---- h_{t-1} and y_{t-1} into shared memory ----
    if (t == 0) {
      for (int idx = threadIdx.x; idx < B * H; idx += kThreads)
        h_s[(size_t)(idx / H) * Hs + idx % H] = round_w<W>(a.h0[idx]);
      for (int idx = threadIdx.x; idx < B * nu; idx += kThreads)
        hown_s[(idx / nu) * U + idx % nu] = a.h0[(size_t)(idx / nu) * H + j0 + idx % nu];
      for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) y_s[idx] = a.y0[idx];
    } else {
      const float* src = a.hbuf + (size_t)cur * B * Hs;
      for (int q = threadIdx.x; q < B * Hs / 4; q += kThreads) cp_async16(h_s + 4 * q, src + 4 * q);
      reduce_y(a, a.ypart + (size_t)cur * G * a.BOs, stage, y_s, G, t - 1, k == 0);
    }
    cp_async_wait_all();
    __syncthreads();
    PROF_MARK(0);

    // ---- a warp per own unit: its 3 gate rows, then its gates and h_t ----
    for (int u = warp; u < nu; u += kWarps) {
      const int j = j0 + u;
      const W* wr = whh_s + (size_t)u * H;
      const W* wz = whh_s + (size_t)(U + u) * H;
      const W* wn = whh_s + (size_t)(2 * U + u) * H;
      const W* vr = wy_s + (size_t)u * OUT;
      const W* vz = wy_s + (size_t)(U + u) * OUT;
      const W* vn = wy_s + (size_t)(2 * U + u) * OUT;
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        const int bl = b0 + lane;  // the batch row that lanes 0-3 finish
        const bool finisher = lane < kBatchChunk && bl < B;
        const size_t bt = (size_t)bl * T + t;
        float gxr = 0.f, gxz = 0.f, gxn = 0.f, m = 1.f;
        if (finisher) {  // streamed gates (and mask): in flight during the dot products
          const W* g = gx + bt * 3 * H + j;
          gxr = to_f(g[0]);
          gxz = to_f(g[H]);
          gxn = to_f(g[2 * H]);
          if constexpr (kTrain) m = to_f(mask[bt * H + j]);
        }
        // r and z sum their h and y products together; n keeps them apart.
        // Rows past B repeat row B-1 and are dropped: branch-free, so the
        // compiler batches the loads instead of waiting out each one.
        int row[kBatchChunk];
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) row[c] = min(b0 + c, B - 1);
        float sr[kBatchChunk] = {}, sz[kBatchChunk] = {}, shn[kBatchChunk] = {}, syn[kBatchChunk] = {};
        if (regs) {  // u == warp
#pragma unroll
          for (int it = 0; it < kRegIters; ++it) {
            const int i = 128 * it + 4 * lane;
            if (i < H) {
#pragma unroll
              for (int c = 0; c < kBatchChunk; ++c) {
                const float4 v = *reinterpret_cast<const float4*>(h_s + (size_t)row[c] * Hs + i);
                sr[c] = dot4(wreg[0][it], v, sr[c]);
                sz[c] = dot4(wreg[1][it], v, sz[c]);
                shn[c] = dot4(wreg[2][it], v, shn[c]);
              }
            }
          }
        } else if (H % 4 == 0) {  // rows start on 16 (float) or 8 (bf16) bytes
          for (int i = 4 * lane; i < H; i += 128) {
            const float4 w0 = load4(wr + i), w1 = load4(wz + i), w2 = load4(wn + i);
#pragma unroll
            for (int c = 0; c < kBatchChunk; ++c) {
              const float4 v = *reinterpret_cast<const float4*>(h_s + (size_t)row[c] * Hs + i);
              sr[c] = dot4(w0, v, sr[c]);
              sz[c] = dot4(w1, v, sz[c]);
              shn[c] = dot4(w2, v, shn[c]);
            }
          }
        } else {
          for (int i = lane; i < H; i += 32) {
            const float w0 = to_f(wr[i]), w1 = to_f(wz[i]), w2 = to_f(wn[i]);
#pragma unroll
            for (int c = 0; c < kBatchChunk; ++c) {
              const float v = h_s[(size_t)row[c] * Hs + i];
              sr[c] = fmaf(w0, v, sr[c]);
              sz[c] = fmaf(w1, v, sz[c]);
              shn[c] = fmaf(w2, v, shn[c]);
            }
          }
        }
        for (int o = lane; o < OUT; o += 32) {
          const float w0 = to_f(vr[o]), w1 = to_f(vz[o]), w2 = to_f(vn[o]);
#pragma unroll
          for (int c = 0; c < kBatchChunk; ++c) {
            const float v = round_w<W>(y_s[row[c] * OUT + o]);
            sr[c] = fmaf(w0, v, sr[c]);
            sz[c] = fmaf(w1, v, sz[c]);
            syn[c] = fmaf(w2, v, syn[c]);
          }
        }
        PROF_MARK(1);
        float tr = 0.f, tz = 0.f, thn = 0.f, tyn = 0.f;
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) {  // butterfly: every lane gets every sum
          const float s0 = warp_sum(sr[c]), s1 = warp_sum(sz[c]);
          const float s2 = warp_sum(shn[c]), s3 = warp_sum(syn[c]);
          if (lane == c) {
            tr = s0;
            tz = s1;
            thn = s2;
            tyn = s3;
          }
        }
        PROF_MARK(2);
        if (finisher) {
          const float rg = sigmoid_f(gxr + (tr + bhh_s[u]));
          const float zg = sigmoid_f(gxz + (tz + bhh_s[U + u]));
          const float ng = tanhf((gxn + tyn) + rg * (thn + bhh_s[2 * U + u]));
          float* own = hown_s + bl * U + u;
          const float hnew = (1.f - zg) * ng + zg * *own;
          *own = hnew;
          __stcg(a.hbuf + (size_t)nxt * B * Hs + (size_t)bl * Hs + j, round_w<W>(hnew));
          if constexpr (kTrain) {
            hseq[bt * H + j] = from_f<W>(hnew);
            hn_s[bl * U + u] = round_w<W>(hnew * m);
          } else {
            hn_s[bl * U + u] = round_w<W>(hnew);
          }
        }
        PROF_MARK(3);
      }
    }
    __syncthreads();
    PROF_MARK(4);

    // ---- this block's partial of y_t over its units ----
    float* part = a.ypart + ((size_t)nxt * G + k) * a.BOs;
    for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) {
      const int b = idx / OUT, o = idx % OUT;
      float s = 0.f;
      for (int u = 0; u < nu; ++u) s = fmaf(hn_s[b * U + u], to_f(wout_s[u * OUT + o]), s);
      __stcg(part + idx, s);
    }
    PROF_MARK(5);
    grid.sync();
    PROF_MARK(6);
  }

  // ---- the last frame's h (each block its units) and y (block 0) ----
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads)
    a.h_last[(size_t)(idx / nu) * H + j0 + idx % nu] = hown_s[(idx / nu) * U + idx % nu];
  if (k == 0) {
    reduce_y(a, a.ypart + (size_t)(T & 1) * G * a.BOs, stage, y_s, G, T - 1, true);
    for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) a.y_last[idx] = y_s[idx];
  }
}

template <typename W, bool kTrain>
int plan(int B, int H, int out, int* grid, int* units, int* stage_rows, int* smem) {
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e != cudaSuccess) return e;
  const size_t BOs = up4((size_t)B * out);
  // fewest units per block (most blocks) whose grid is co-resident; the
  // y stage takes what shared memory is left, up to all B*out rows
  for (int U = (H + sms - 1) / sms; U <= H; ++U) {
    const int G = (H + U - 1) / U;
    const size_t base = smem_layout(B, H, out, U, G, 0, sizeof(W)).total_bytes;
    const size_t row_bytes = (size_t)G * sizeof(float);
    if (base + 4 * row_bytes > (size_t)optin) continue;
    const int rows = (int)std::min(BOs, (optin - base) / row_bytes / 4 * 4);
    const size_t s = smem_layout(B, H, out, U, G, rows, sizeof(W)).total_bytes;
    bool fits = false;
    e = co_resident(gru_ar_kernel<W, kTrain>, s, sms, G, &fits);
    if (e != cudaSuccess) return e;
    if (fits) {
      *grid = G;
      *units = U;
      *stage_rows = rows;
      *smem = (int)s;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // B rows of h do not fit in shared memory
}

template <typename W, bool kTrain>
int launch(const void* gx, const void* wy, const void* whh, const void* bhh, const void* wout,
           const void* bout, const void* y0, const void* h0, const void* mask, void* trj,
           void* y_last, void* h_last, void* hseq, void* hbuf, void* ypart, int B, int T, int H,
           int out, int grid, int units, int stage_rows, int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || out < 1 || units < 1 || stage_rows < 4 || stage_rows % 4 ||
      (long long)grid * units < H || (kTrain && (mask == nullptr || hseq == nullptr)))
    return cudaErrorInvalidValue;
  Args a{gx, wy, whh, static_cast<const float*>(bhh), wout, static_cast<const float*>(bout),
         static_cast<const float*>(y0), static_cast<const float*>(h0), mask,
         static_cast<float*>(trj), static_cast<float*>(y_last), static_cast<float*>(h_last), hseq,
         static_cast<float*>(hbuf), static_cast<float*>(ypart), B, T, H, out, units, (int)up4(H),
         (int)up4((size_t)B * out), stage_rows};
  cudaError_t e = cudaFuncSetAttribute(gru_ar_kernel<W, kTrain>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gru_ar_kernel<W, kTrain>),
                                  dim3(grid), dim3(kThreads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks, units per block, y-stage rows and dynamic shared bytes for one call
int gru_ar_plan_f32(int B, int H, int out, int* grid, int* units, int* stage_rows, int* smem) {
  return plan<float, false>(B, H, out, grid, units, stage_rows, smem);
}
int gru_ar_plan_bf16(int B, int H, int out, int* grid, int* units, int* stage_rows, int* smem) {
  return plan<__nv_bfloat16, false>(B, H, out, grid, units, stage_rows, smem);
}
int gru_ar_train_plan_f32(int B, int H, int out, int* grid, int* units, int* stage_rows,
                          int* smem) {
  return plan<float, true>(B, H, out, grid, units, stage_rows, smem);
}
int gru_ar_train_plan_bf16(int B, int H, int out, int* grid, int* units, int* stage_rows,
                           int* smem) {
  return plan<__nv_bfloat16, true>(B, H, out, grid, units, stage_rows, smem);
}

// hbuf: (2, B, Hs) floats and ypart: (2, grid, BOs) floats, Hs and BOs being
// H and B*out rounded up to multiples of 4
int gru_ar_f32(const void* gx, const void* wy, const void* whh, const void* bhh, const void* wout,
               const void* bout, const void* y0, const void* h0, void* trj, void* y_last,
               void* h_last, void* hbuf, void* ypart, int B, int T, int H, int out, int grid,
               int units, int stage_rows, int smem, void* stream) {
  return launch<float, false>(gx, wy, whh, bhh, wout, bout, y0, h0, nullptr, trj, y_last, h_last,
                              nullptr, hbuf, ypart, B, T, H, out, grid, units, stage_rows, smem,
                              stream);
}
int gru_ar_bf16(const void* gx, const void* wy, const void* whh, const void* bhh, const void* wout,
                const void* bout, const void* y0, const void* h0, void* trj, void* y_last,
                void* h_last, void* hbuf, void* ypart, int B, int T, int H, int out, int grid,
                int units, int stage_rows, int smem, void* stream) {
  return launch<__nv_bfloat16, false>(gx, wy, whh, bhh, wout, bout, y0, h0, nullptr, trj, y_last,
                                      h_last, nullptr, hbuf, ypart, B, T, H, out, grid, units,
                                      stage_rows, smem, stream);
}

// training forward: mask (B, T, H) in, h_seq (B, T, H) out, both at the
// weight type; the rest as gru_ar_*
int gru_ar_train_f32(const void* gx, const void* wy, const void* whh, const void* bhh,
                     const void* wout, const void* bout, const void* y0, const void* h0,
                     const void* mask, void* trj, void* y_last, void* h_last, void* hseq,
                     void* hbuf, void* ypart, int B, int T, int H, int out, int grid, int units,
                     int stage_rows, int smem, void* stream) {
  return launch<float, true>(gx, wy, whh, bhh, wout, bout, y0, h0, mask, trj, y_last, h_last,
                             hseq, hbuf, ypart, B, T, H, out, grid, units, stage_rows, smem,
                             stream);
}
int gru_ar_train_bf16(const void* gx, const void* wy, const void* whh, const void* bhh,
                      const void* wout, const void* bout, const void* y0, const void* h0,
                      const void* mask, void* trj, void* y_last, void* h_last, void* hseq,
                      void* hbuf, void* ypart, int B, int T, int H, int out, int grid, int units,
                      int stage_rows, int smem, void* stream) {
  return launch<__nv_bfloat16, true>(gx, wy, whh, bhh, wout, bout, y0, h0, mask, trj, y_last,
                                     h_last, hseq, hbuf, ypart, B, T, H, out, grid, units,
                                     stage_rows, smem, stream);
}

#ifdef GRU_AR_PROFILE
int gru_ar_profile_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[7] = {};
  return cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
