// Reverse-time cotangent scan of the autoregressive GRU (the training
// backward) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel cyclevae_tpu/ops/pallas_gru.py:_kernel_bwd
// (wrapper pallas_gru_ar_bwd).  For t = T-1 down to 0, with the carries dh
// (B, H) and dy (B, out) starting at dh_T and dy_T:
//   recompute  gx = gates_x[t] + y_prev[t] . Wy^T,  gh = h_prev[t] . Whh^T + b_hh,
//              r, z, n as in the forward (ghn = gh_n)
//   dy_tot = d_trj[t] + dy                         (emitted)
//   dh_tot = dh + (dy_tot . Wout) * mask[t]
//   dz = dh_tot (h_prev - n), dn = dh_tot (1 - z), dgn = dn (1 - n^2),
//   dr = dgn ghn, dgr = dr r (1 - r), dgz = dz z (1 - z), dghn = dgn r
//   dgx = [dgr, dgz, dgn], dgh = [dgr, dgz, dghn]  (emitted at the weight type W)
//   dh  = dh_tot z + dgh . Whh                     (sum over all 3H gate rows)
//   dy  = dgx . Wy                                 (sum over all 3H gate rows)
// and at the end dh_0 = dh, dy_0 = dy.  gates_x, y_prev, h_prev and mask
// stream at W; every operand of a product is rounded to W where the TPU
// kernel casts it (dy_tot, dgh, dgx); the carries and the gate algebra stay
// float; products accumulate in float.
//
// What bounds it on this card: as for the forward (gru_ar.cu), the latency of
// one step times T, not bytes or FLOPs.  The recompute needs only the
// streamed residuals and is data-parallel; the sequential chain crosses
// blocks twice per step, in dh (a sum over all 3H rows of dgh) and in dy (a
// sum over all 3H rows of dgx).  The design keeps ONE grid barrier per step:
//   * ONE cooperative launch runs all T steps; block k owns hidden units
//     [kU, kU+U), so 3U gate rows.  Up to H=1024 each warp holds its unit's
//     three Whh rows in registers (the recompute), as the forward does; the
//     block's 3U rows of Wy, its U columns of Wout and its U columns of Whh
//     (all 3H rows: the dh product) sit in shared memory.
//   * Per step a warp takes one own unit and up to 4 batch rows: the dot
//     products of the recompute (h_prev . 3 Whh rows, y_prev . 3 Wy rows) and
//     of dy_tot . Wout[:, j], warp sums, then lanes 0-3 finish the gates and
//     the cotangent algebra of that unit.  They write dgx and dgh, rounded to
//     W, to the outputs and dgh also to double-buffered global scratch; the
//     block then writes its partial of dy over its 3U rows.  Then the grid
//     barrier.
//   * After it, every block copies the whole dgh (B, 3H) into shared memory
//     with cp.async, in chunks of rows as shared memory allows, and forms dh
//     for its units against its Whh columns; then it copies the G partials of
//     dy and sums them in a fixed order.  No atomics: the result is
//     deterministic.  Step s writes buffer s%2, so a block that runs ahead
//     cannot overwrite what a slower block still reads.
// The plan raises for a shape whose B rows do not fit; it never falls back.

#include <algorithm>

#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru;

struct Args {
  const float* dtrj;   // (B, T, out)
  const void* gx;      // (B, T, 3H) weight type
  const void* yprev;   // (B, T, out) weight type
  const void* hprev;   // (B, T, H)  weight type
  const void* mask;    // (B, T, H)  weight type
  const void* wout;    // (out, H)   weight type
  const void* whh;     // (3H, H)    weight type
  const void* wy;      // (3H, out)  weight type
  const float* bhh;    // (3H)
  const float* dhT;    // (B, H)
  const float* dyT;    // (B, out)
  void* dgx;           // (B, T, 3H) weight type
  void* dgh;           // (B, T, 3H) weight type
  float* dytot;        // (B, T, out)
  float* dh0;          // (B, H)
  float* dy0;          // (B, out)
  void* dghbuf;        // (2, B, Gs) weight type, scratch; columns >= 3H stay zero
  float* dypart;       // (2, G, BOs) scratch, block k's partial of dy at [k]
  int B, T, H, out, U;
  int Hs, Gs, BOs;     // H, 3H (multiple of 8) and B*out (multiple of 4) padded
  int chunk;           // dgh columns (multiple of 8) copied per pass
  int stage_rows;      // dy values (multiple of 4) summed per pass
};

struct Smem {  // offsets in floats; every array starts on 16 bytes
  size_t scr, yp, dyt, dh, dhz, dgxo, red, bhh, w, total_bytes;
};

// scr is shared by h_prev[t] (B*Hs floats, the recompute), a chunk of dgh
// (B*chunk at W) and the dy stage (G*stage_rows floats): they are used one
// after another
__host__ __device__ inline Smem smem_layout(int B, int H, int out, int U, size_t scr_floats,
                                            int wbytes) {
  const size_t R = 3 * (size_t)U;
  Smem s;
  s.scr = 0;
  s.yp = s.scr + up4(scr_floats);              // B*out    y_prev[t], float
  s.dyt = s.yp + up4((size_t)B * out);         // B*out    dy_tot, float
  s.dh = s.dyt + up4((size_t)B * out);         // B*U      own dh carry
  s.dhz = s.dh + up4((size_t)B * U);           // B*U      own dh_tot * z
  s.dgxo = s.dhz + up4((size_t)B * U);         // B*3U     own dgx, rounded to W
  s.red = s.dgxo + up4((size_t)B * R);         // B*kThreads partial sums of the dh product
  s.bhh = s.red + (size_t)B * kThreads;        // 3U       own rows of b_hh
  s.w = s.bhh + up4(R);                        // [Whh rows 3U*H,] Wy 3U*out, Wout U*out, Whh cols Gs*U
  const size_t whh = whh_in_regs(H, U) ? 0 : R * H;
  const size_t gs = up8(3 * (size_t)H);
  s.total_bytes = s.w * sizeof(float) + (whh + R * out + (size_t)U * out + gs * U) * wbytes;
  return s;
}

// floats of the scratch region: the largest of its three uses
__host__ __device__ inline size_t scr_size(int B, size_t Hs, size_t chunk, size_t wbytes, int G,
                                           size_t stage_rows) {
  const size_t hp = (size_t)B * Hs, dgh = ((size_t)B * chunk * wbytes + 3) / 4;
  const size_t stage = (size_t)G * stage_rows;
  const size_t m = hp > dgh ? hp : dgh;
  return m > stage ? m : stage;
}

template <typename W>
struct Ptrs {
  float *scr, *yp, *dyt, *dh, *dhz, *dgxo, *red, *bhh;
  W *whh_s, *wy_s, *wout_s, *whc_s;
};

// After the barrier of step s (buffers p = s % 2): dh for the block's own
// units, dh = dh_tot z + dgh . Whh[:, own], from the whole dgh copied in
// chunks.  Thread (q, u) sums rows 4q, 4q + 4 nq, ... of each chunk.
template <typename W>
__device__ void dh_from_dgh(const Args& a, const Ptrs<W>& P, int p, int nu) {
  const int B = a.B, U = a.U, C = a.chunk, Gs = a.Gs;
  const int nq = kThreads / U, u = threadIdx.x % U, q = threadIdx.x / U;
  const bool active = q < nq && u < nu;
  const W* src = static_cast<const W*>(a.dghbuf) + (size_t)p * B * Gs;
  W* chunk_s = reinterpret_cast<W*>(P.scr);
  constexpr int kPer16 = 16 / sizeof(W);  // values per 16-byte copy
  for (int b = 0; b < B; ++b) P.red[b * kThreads + threadIdx.x] = 0.f;
  for (int c0 = 0; c0 < 3 * a.H; c0 += C) {
    const int cc = min(C, Gs - c0);  // a multiple of 8
    const int per_row = cc / kPer16;
    for (int i = threadIdx.x; i < B * per_row; i += kThreads) {
      const int b = i / per_row, c = i % per_row;
      cp_async16(chunk_s + (size_t)b * C + c * kPer16, src + (size_t)b * Gs + c0 + c * kPer16);
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        int row[kBatchChunk];
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) row[c] = min(b0 + c, B - 1);
        float acc[kBatchChunk] = {};
        for (int g = 4 * q; g < cc; g += 4 * nq) {
          const W* wc = P.whc_s + (size_t)(c0 + g) * U + u;
          const float4 w = make_float4(to_f(wc[0]), to_f(wc[U]), to_f(wc[2 * U]), to_f(wc[3 * U]));
#pragma unroll
          for (int c = 0; c < kBatchChunk; ++c)
            acc[c] = dot4(load4(chunk_s + (size_t)row[c] * C + g), w, acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c)
          if (b0 + c < B) P.red[(b0 + c) * kThreads + threadIdx.x] += acc[c];
      }
    }
    __syncthreads();  // the chunk is refilled by the next pass
  }
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, uu = idx % nu;
    float s = 0.f;
    for (int qq = 0; qq < nq; ++qq) s += P.red[b * kThreads + qq * U + uu];
    P.dh[b * U + uu] = P.dhz[b * U + uu] + s;
  }
  __syncthreads();
}

template <typename W>
__global__ void __launch_bounds__(kThreads) gru_ar_bwd_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, OUT = a.out, U = a.U, Hs = a.Hs, Gs = a.Gs;
  const int G = gridDim.x, k = blockIdx.x, j0 = k * U;
  const int nu = max(0, min(U, H - j0));  // units this block owns (last block may be ragged)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Smem L = smem_layout(B, H, OUT, U, scr_size(B, Hs, a.chunk, sizeof(W), G, a.stage_rows),
                             sizeof(W));
  const bool regs = whh_in_regs(H, U);

  Ptrs<W> P;
  P.scr = smem + L.scr;
  P.yp = smem + L.yp;
  P.dyt = smem + L.dyt;
  P.dh = smem + L.dh;
  P.dhz = smem + L.dhz;
  P.dgxo = smem + L.dgxo;
  P.red = smem + L.red;
  P.bhh = smem + L.bhh;
  P.whh_s = reinterpret_cast<W*>(smem + L.w);  // row g*U + u: gate g of unit j0+u
  P.wy_s = P.whh_s + (regs ? 0 : (size_t)3 * U * H);
  P.wout_s = P.wy_s + (size_t)3 * U * OUT;       // [u][o] = Wout[o][j0+u]
  P.whc_s = P.wout_s + (size_t)U * OUT;          // [g][u] = Whh[g][j0+u], rows >= 3H zero
  float* hp_s = P.scr;

  const W* gx = static_cast<const W*>(a.gx);
  const W* yprev = static_cast<const W*>(a.yprev);
  const W* hprev = static_cast<const W*>(a.hprev);
  const W* mask = static_cast<const W*>(a.mask);
  const W* wy = static_cast<const W*>(a.wy);
  const W* whh = static_cast<const W*>(a.whh);
  const W* wout = static_cast<const W*>(a.wout);
  W* dgx = static_cast<W*>(a.dgx);
  W* dgh = static_cast<W*>(a.dgh);

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
      if (u < nu) P.whh_s[idx] = whh[(size_t)(g * H + j0 + u) * H + i];
    }
  }
  for (int idx = threadIdx.x; idx < 3 * U * OUT; idx += kThreads) {
    const int r = idx / OUT, o = idx % OUT, g = r / U, u = r % U;
    if (u < nu) P.wy_s[idx] = wy[(size_t)(g * H + j0 + u) * OUT + o];
  }
  for (int idx = threadIdx.x; idx < U * OUT; idx += kThreads) {
    const int u = idx / OUT, o = idx % OUT;
    if (u < nu) P.wout_s[idx] = wout[(size_t)o * H + j0 + u];
  }
  for (int idx = threadIdx.x; idx < Gs * U; idx += kThreads) {
    const int g = idx / U, u = idx % U;
    P.whc_s[idx] = (g < 3 * H && u < nu) ? whh[(size_t)g * H + j0 + u] : from_f<W>(0.f);
  }
  for (int r = threadIdx.x; r < 3 * U; r += kThreads) {
    const int g = r / U, u = r % U;
    P.bhh[r] = u < nu ? a.bhh[g * H + j0 + u] : 0.f;
  }
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads)
    P.dh[(idx / nu) * U + idx % nu] = a.dhT[(size_t)(idx / nu) * H + j0 + idx % nu];
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s, cur = s & 1;

    // ---- the carries: dh (own units) and dy_tot = d_trj[t] + dy ----
    if (s == 0) {
      for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) {
        const int b = idx / OUT, o = idx % OUT;
        P.dyt[idx] = a.dtrj[((size_t)b * T + t) * OUT + o] + a.dyT[idx];
      }
    } else {
      const int prv = cur ^ 1;
      dh_from_dgh<W>(a, P, prv, nu);
      sum_partials(a.dypart + (size_t)prv * G * a.BOs, P.scr, G, B * OUT, a.BOs, a.stage_rows,
                   [&](int idx, float v) {
                     const int b = idx / OUT, o = idx % OUT;
                     P.dyt[idx] = a.dtrj[((size_t)b * T + t) * OUT + o] + v;
                   });
    }
    // ---- h_prev[t] and y_prev[t] (the streamed residuals) ----
    for (int idx = threadIdx.x; idx < B * H; idx += kThreads) {
      const int b = idx / H, i = idx % H;
      hp_s[(size_t)b * Hs + i] = to_f(hprev[((size_t)b * T + t) * H + i]);
    }
    for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) {
      const int b = idx / OUT, o = idx % OUT;
      P.yp[idx] = to_f(yprev[((size_t)b * T + t) * OUT + o]);
    }
    __syncthreads();

    // ---- a warp per own unit: recompute its gates, then its cotangents ----
    for (int u = warp; u < nu; u += kWarps) {
      const int j = j0 + u;
      const W* wr = P.whh_s + (size_t)u * H;
      const W* wz = P.whh_s + (size_t)(U + u) * H;
      const W* wn = P.whh_s + (size_t)(2 * U + u) * H;
      const W* vr = P.wy_s + (size_t)u * OUT;
      const W* vz = P.wy_s + (size_t)(U + u) * OUT;
      const W* vn = P.wy_s + (size_t)(2 * U + u) * OUT;
      const W* vo = P.wout_s + (size_t)u * OUT;
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        const int bl = b0 + lane;  // the batch row that lanes 0-3 finish
        const bool finisher = lane < kBatchChunk && bl < B;
        const size_t bt = (size_t)bl * T + t;
        float gxr = 0.f, gxz = 0.f, gxn = 0.f, m = 0.f;
        if (finisher) {  // streamed gates and mask: in flight during the dot products
          const W* g = gx + bt * 3 * H + j;
          gxr = to_f(g[0]);
          gxz = to_f(g[H]);
          gxn = to_f(g[2 * H]);
          m = to_f(mask[bt * H + j]);
        }
        int row[kBatchChunk];
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) row[c] = min(b0 + c, B - 1);
        float sr[kBatchChunk] = {}, sz[kBatchChunk] = {}, shn[kBatchChunk] = {},
              syn[kBatchChunk] = {}, sdo[kBatchChunk] = {};
        if (regs) {  // u == warp
#pragma unroll
          for (int it = 0; it < kRegIters; ++it) {
            const int i = 128 * it + 4 * lane;
            if (i < H) {
#pragma unroll
              for (int c = 0; c < kBatchChunk; ++c) {
                const float4 v = *reinterpret_cast<const float4*>(hp_s + (size_t)row[c] * Hs + i);
                sr[c] = dot4(wreg[0][it], v, sr[c]);
                sz[c] = dot4(wreg[1][it], v, sz[c]);
                shn[c] = dot4(wreg[2][it], v, shn[c]);
              }
            }
          }
        } else if (H % 4 == 0) {
          for (int i = 4 * lane; i < H; i += 128) {
            const float4 w0 = load4(wr + i), w1 = load4(wz + i), w2 = load4(wn + i);
#pragma unroll
            for (int c = 0; c < kBatchChunk; ++c) {
              const float4 v = *reinterpret_cast<const float4*>(hp_s + (size_t)row[c] * Hs + i);
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
              const float v = hp_s[(size_t)row[c] * Hs + i];
              sr[c] = fmaf(w0, v, sr[c]);
              sz[c] = fmaf(w1, v, sz[c]);
              shn[c] = fmaf(w2, v, shn[c]);
            }
          }
        }
        for (int o = lane; o < OUT; o += 32) {
          const float w0 = to_f(vr[o]), w1 = to_f(vz[o]), w2 = to_f(vn[o]), w3 = to_f(vo[o]);
#pragma unroll
          for (int c = 0; c < kBatchChunk; ++c) {
            const float v = P.yp[row[c] * OUT + o];  // already at W
            sr[c] = fmaf(w0, v, sr[c]);
            sz[c] = fmaf(w1, v, sz[c]);
            syn[c] = fmaf(w2, v, syn[c]);
            sdo[c] = fmaf(w3, round_w<W>(P.dyt[row[c] * OUT + o]), sdo[c]);
          }
        }
        float tr = 0.f, tz = 0.f, thn = 0.f, tyn = 0.f, tdo = 0.f;
#pragma unroll
        for (int c = 0; c < kBatchChunk; ++c) {  // butterfly: every lane gets every sum
          const float s0 = warp_sum(sr[c]), s1 = warp_sum(sz[c]);
          const float s2 = warp_sum(shn[c]), s3 = warp_sum(syn[c]), s4 = warp_sum(sdo[c]);
          if (lane == c) {
            tr = s0;
            tz = s1;
            thn = s2;
            tyn = s3;
            tdo = s4;
          }
        }
        if (finisher) {
          const float rg = sigmoid_f(gxr + (tr + P.bhh[u]));
          const float zg = sigmoid_f(gxz + (tz + P.bhh[U + u]));
          const float ghn = thn + P.bhh[2 * U + u];
          const float ng = tanhf((gxn + tyn) + rg * ghn);
          const float hp = hp_s[(size_t)bl * Hs + j];
          const float dh_tot = P.dh[bl * U + u] + tdo * m;
          const float dz = dh_tot * (hp - ng);
          const float dn = dh_tot * (1.f - zg);
          const float dgn = dn * (1.f - ng * ng);
          const float dr = dgn * ghn;
          const float dghn = dgn * rg;
          const float dgr = dr * rg * (1.f - rg);
          const float dgz = dz * zg * (1.f - zg);
          const W qr = from_f<W>(dgr), qz = from_f<W>(dgz), qn = from_f<W>(dgn),
                  qhn = from_f<W>(dghn);
          W* ox = dgx + bt * 3 * H + j;
          W* oh = dgh + bt * 3 * H + j;
          ox[0] = qr;
          ox[H] = qz;
          ox[2 * H] = qn;
          oh[0] = qr;
          oh[H] = qz;
          oh[2 * H] = qhn;
          W* buf = static_cast<W*>(a.dghbuf) + ((size_t)cur * B + bl) * Gs + j;
          buf[0] = qr;
          buf[H] = qz;
          buf[2 * H] = qhn;
          float* xo = P.dgxo + (size_t)bl * 3 * U + u;
          xo[0] = to_f(qr);
          xo[U] = to_f(qz);
          xo[2 * U] = to_f(qn);
          P.dhz[bl * U + u] = dh_tot * zg;
        }
      }
    }
    __syncthreads();

    // ---- this block's partial of dy over its 3U rows; dy_tot out (block 0) ----
    float* part = a.dypart + ((size_t)cur * G + k) * a.BOs;
    for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) {
      const int b = idx / OUT, o = idx % OUT;
      float acc = 0.f;
      for (int g = 0; g < 3; ++g)
        for (int u = 0; u < nu; ++u)
          acc = fmaf(P.dgxo[(size_t)b * 3 * U + g * U + u], to_f(P.wy_s[(size_t)(g * U + u) * OUT + o]),
                     acc);
      __stcg(part + idx, acc);
      if (k == 0) a.dytot[((size_t)b * T + t) * OUT + o] = P.dyt[idx];
    }
    grid.sync();
  }

  // ---- dh_0 (each block its units) and dy_0 (block 0) ----
  const int last = (T - 1) & 1;
  dh_from_dgh<W>(a, P, last, nu);
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads)
    a.dh0[(size_t)(idx / nu) * H + j0 + idx % nu] = P.dh[(idx / nu) * U + idx % nu];
  if (k == 0)
    sum_partials(a.dypart + (size_t)last * G * a.BOs, P.scr, G, B * OUT, a.BOs, a.stage_rows,
                 [&](int idx, float v) { a.dy0[idx] = v; });
}

template <typename W>
int plan(int B, int H, int out, int* grid, int* units, int* chunk, int* stage_rows, int* smem) {
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e != cudaSuccess) return e;
  const size_t BOs = up4((size_t)B * out), Gs = up8(3 * (size_t)H), Hs = up4(H);
  // fewest units per block (most blocks) whose grid is co-resident; the
  // scratch region holds h_prev[t] and takes what shared memory is left for
  // the dgh chunks and the dy stage, up to all of either
  for (int U = (H + sms - 1) / sms; U <= H && U <= kThreads; ++U) {
    const int G = (H + U - 1) / U;
    const size_t fixed = smem_layout(B, H, out, U, 0, sizeof(W)).total_bytes;
    if (fixed + (size_t)B * Hs * 4 > (size_t)optin) continue;
    const size_t avail = optin - fixed;
    const size_t c = std::min(Gs, avail / ((size_t)B * sizeof(W)) / 8 * 8);
    const size_t rows = std::min(BOs, avail / ((size_t)G * 4) / 4 * 4);
    if (c < 8 || rows < 4) continue;
    const size_t s =
        smem_layout(B, H, out, U, scr_size(B, Hs, c, sizeof(W), G, rows), sizeof(W)).total_bytes;
    bool fits = false;
    e = co_resident(gru_ar_bwd_kernel<W>, s, sms, G, &fits);
    if (e != cudaSuccess) return e;
    if (fits) {
      *grid = G;
      *units = U;
      *chunk = (int)c;
      *stage_rows = (int)rows;
      *smem = (int)s;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // B rows do not fit in shared memory
}

template <typename W>
int launch(const void* dtrj, const void* gx, const void* yprev, const void* hprev,
           const void* mask, const void* wout, const void* whh, const void* wy, const void* bhh,
           const void* dhT, const void* dyT, void* dgx, void* dgh, void* dytot, void* dh0,
           void* dy0, void* dghbuf, void* dypart, int B, int T, int H, int out, int grid, int units,
           int chunk, int stage_rows, int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || out < 1 || units < 1 || units > kThreads || chunk < 8 ||
      chunk % 8 || stage_rows < 4 || stage_rows % 4 || (long long)grid * units < H)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(dtrj), gx, yprev, hprev, mask, wout, whh, wy,
         static_cast<const float*>(bhh), static_cast<const float*>(dhT),
         static_cast<const float*>(dyT), dgx, dgh, static_cast<float*>(dytot),
         static_cast<float*>(dh0), static_cast<float*>(dy0), dghbuf, static_cast<float*>(dypart),
         B, T, H, out, units, (int)up4(H), (int)up8(3 * (size_t)H), (int)up4((size_t)B * out),
         chunk, stage_rows};
  cudaError_t e = cudaFuncSetAttribute(gru_ar_bwd_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gru_ar_bwd_kernel<W>), dim3(grid),
                                  dim3(kThreads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks, units per block, dgh columns per copy, dy-stage rows and dynamic
// shared bytes for one call
int gru_ar_bwd_plan_f32(int B, int H, int out, int* grid, int* units, int* chunk, int* stage_rows,
                        int* smem) {
  return plan<float>(B, H, out, grid, units, chunk, stage_rows, smem);
}
int gru_ar_bwd_plan_bf16(int B, int H, int out, int* grid, int* units, int* chunk, int* stage_rows,
                         int* smem) {
  return plan<__nv_bfloat16>(B, H, out, grid, units, chunk, stage_rows, smem);
}

// dghbuf: (2, B, Gs) at the weight type, zero-filled (Gs = 3H rounded up to a
// multiple of 8); dypart: (2, grid, BOs) floats (BOs = B*out rounded up to a
// multiple of 4)
int gru_ar_bwd_f32(const void* dtrj, const void* gx, const void* yprev, const void* hprev,
                   const void* mask, const void* wout, const void* whh, const void* wy,
                   const void* bhh, const void* dhT, const void* dyT, void* dgx, void* dgh,
                   void* dytot, void* dh0, void* dy0, void* dghbuf, void* dypart, int B, int T,
                   int H, int out, int grid, int units, int chunk, int stage_rows, int smem,
                   void* stream) {
  return launch<float>(dtrj, gx, yprev, hprev, mask, wout, whh, wy, bhh, dhT, dyT, dgx, dgh, dytot,
                       dh0, dy0, dghbuf, dypart, B, T, H, out, grid, units, chunk, stage_rows, smem,
                       stream);
}
int gru_ar_bwd_bf16(const void* dtrj, const void* gx, const void* yprev, const void* hprev,
                    const void* mask, const void* wout, const void* whh, const void* wy,
                    const void* bhh, const void* dhT, const void* dyT, void* dgx, void* dgh,
                    void* dytot, void* dh0, void* dy0, void* dghbuf, void* dypart, int B, int T,
                    int H, int out, int grid, int units, int chunk, int stage_rows, int smem,
                    void* stream) {
  return launch<__nv_bfloat16>(dtrj, gx, yprev, hprev, mask, wout, whh, wy, bhh, dhT, dyT, dgx,
                               dgh, dytot, dh0, dy0, dghbuf, dypart, B, T, H, out, grid, units,
                               chunk, stage_rows, smem, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
