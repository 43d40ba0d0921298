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
//   gates[b, t] = r, z, n, gh_n                   (training: the backward's residual,
//                                                  float, so K3 need not recompute them)
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
// the latency of one frame, and much of a frame is what crosses blocks.  The
// design keeps that chain short:
//   * ONE cooperative launch (for the co-residency guarantee) runs the whole
//     time loop; the weights are read from device memory once.  Block k owns
//     hidden units [kU, kU+U) (U=8, 128 blocks at H=1024).  Up to H=1024 the
//     Whh rows sit in registers, as float: warp w holds the rows of units
//     2(w/2) and 2(w/2)+1 over one half of H, so that each float4 of h it
//     reads from shared memory feeds 24 FMAs; the two halves' sums meet in
//     shared memory.  The rows of Wy and the block's U columns of Wout sit in
//     shared memory.  Larger or odd H keeps the Whh rows in shared memory, a
//     warp per unit; the last block may be ragged.
//   * Hop 1, behind one release count: at the end of frame t a block writes
//     its units' h_t (rounded to W and stored at W) and its partial of y_t
//     over its units, laid out by the block that sums each slice of y, then
//     one thread adds to a frame count with release semantics.  No grid
//     barrier.
//   * Hop 2, y by reduce-scatter and a tagged all-gather: after acquiring the
//     count, every block starts copying all of h_t (cp.async), and block k's
//     warp 0 loads its slice of the G partials straight from L2 (S = 4
//     values: 2 KB, where every block read all G partials, 64-256 KB), sums
//     it in one fixed order, adds b_out, writes its slice of trj and stores
//     the sums as frame-tagged 8-byte words.  Every block polls the B*out
//     words of y_t; the tags decide.  (A relaxed count of the blocks that
//     stored, polled first as a hint, cost more than it saved on an H100.)
//   * The Whh product needs only h: it runs while hop 2 travels; the
//     gates_x and mask of the next frame are loaded then too.  Once y has
//     arrived, lanes in groups take one (row, unit) each: the Wy products,
//     the gates, h_t.  Then the block's y partial and its arrival.
//   * Buffers double by frame parity: a block writes frame t+2's h slice and
//     partial only after every block has arrived at frame t+1, and every
//     block reads frame t's data before its own arrival at t+1.  Every sum
//     runs in one fixed order and no atomic touches a value: two launches
//     give bitwise equal outputs.  Every spin traps after 2^36 cycles
//     (exchange.cuh).
// The plan sizes the grid from the occupancy query so that every block is
// resident (a cooperative launch refuses more), and raises for a B whose
// rows of h do not fit in shared memory; it never falls back.
//
// Built with -DGRU_AR_PROFILE, thread 0 of block 0 sums the SM cycles each
// phase of a frame takes (gru_ar_profile_read; ops/gru_ar_phases.py names and
// prints them; each PROF_MARK(i) closes phase i): 0 hop-1 wait, 1 y slice
// summed and tagged (warp 0) and h copied, 2 Whh product, 3 hop-2 wait, 4 Wy
// product and gates, 5 y partial and writes, 6 arrival.  On an H100 (B=3,
// f32) the two hops, the slice and the arrival took ~half of a frame's
// ~8,100 cycles and the Whh product a quarter.
//
// Training also keeps each frame's gates r, z, n and gh_n (with b_hh's n
// row) of every own (row, unit): the lane that forms h_t puts them in shared
// memory, and the block writes them out in the next frame, after its hop-1
// wait, while warp 0 sums the y slice and the other warps wait for the copy
// of h.  So no release waits for those stores (the arrival orders every
// earlier write of the block), and they stay off the frame's chain.

#include "exchange.cuh"
#include "gru_common.cuh"

namespace {

using namespace gru;

constexpr int kMaxDevices = 64;
constexpr int kHalfIters = kRegIters / 2;  // float4s of half a Whh row a lane holds

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
  void* hbuf;         // (2, B, Hs) weight type scratch: h_t rounded to W
  float* ypart;       // (2, G, G, S) scratch: [p][k][kk] block kk's partial of block k's y slice
  unsigned long long* ybuf;  // tagged y words (2, YW), then the frame count; zeroed
  int B, T, H, out, U;
  int Hs;             // H rounded up to whole 16-byte pieces of W
  int Ys, YW;         // out rounded up to 4; y in that padded layout, B*Ys values
  int S, owners;      // y values a block sums (a multiple of 4); blocks that own some
  int lanes;          // lanes that take one (row, unit) in the gate phase: 1, 2, 4 or 8
  float* gates;       // (B, T, 4, H) training only: r, z, n, gh_n of every frame (last, so that
                      //   K1's parameters keep their offsets)
};

#ifdef GRU_AR_PROFILE
constexpr int kPhases = 7;
__device__ unsigned long long g_prof[kPhases];
#define PROF_MARK(i)                                            \
  do {                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
      const long long now = clock64();                          \
      prof_acc[i] += now - prof_t;                              \
      prof_t = now;                                             \
    }                                                           \
  } while (0)
#else
#define PROF_MARK(i) \
  do {               \
  } while (0)
#endif

// W values of a row of n, rounded up to whole 16-byte pieces
__host__ __device__ inline int w_row(int n, int wbytes) {
  return (int)((size_t)(n * wbytes + 15) / 16 * 16 / wbytes);
}
// floats that n values of wbytes each take, rounded up to 16 bytes
__host__ __device__ inline size_t wfloats(size_t n, int wbytes) {
  return up4((n * wbytes + 3) / 4);
}
// words of the tagged y buffer before the counts: two frames, then up to a
// 128-byte line, so that the counts share no line with the polled words
__host__ __device__ inline size_t count_word(int YW) { return (2 * (size_t)YW + 15) / 16 * 16; }

struct Smem {  // offsets in floats; every array starts on 16 bytes
  size_t h, y, bout, gh, gx, hn, hown, bhh, whh, wy, wout, total_bytes;
};

__host__ __device__ inline Smem smem_layout(int B, int H, int out, int U, int wbytes) {
  const size_t R = 3 * (size_t)U, BU = (size_t)B * U, Ws = w_row(out, wbytes);
  Smem s;
  s.h = 0;                                          // B*Hs  W  h_{t-1}
  s.y = s.h + wfloats((size_t)B * w_row(H, wbytes), wbytes);  // B*Ys  y_{t-1} rounded to W
  s.bout = s.y + (size_t)B * up4(out);              // Ys       b_out (pads 0)
  s.gh = s.bout + up4(out);                         // 2*3*BU   Whh . h_{t-1} over each half of
                                                    //          H, [half][g][b*U+u]
  s.gx = s.gh + up4(6 * BU);                        // 2*4*BU   gates_x and mask, [p][q][b*U+u]
  s.hn = s.gx + 8 * BU;                             // BU       own o_t rounded to W
  s.hown = s.hn + up4(BU);                          // BU       own h_t, float (the carry)
  s.bhh = s.hown + up4(BU);                         // 3U       own rows of b_hh
  s.whh = s.bhh + up4(R);                           // 3U*H  W  own rows of Whh (not in registers)
  s.wy = s.whh + (whh_in_regs(H, U) ? 0 : wfloats(R * H, wbytes));  // 3U*Ws  W  own rows of Wy
  s.wout = s.wy + wfloats(R * Ws, wbytes);          // U*Ws  W  [u][o] = Wout[o][j0+u]
  s.total_bytes = (s.wout + wfloats((size_t)U * Ws, wbytes)) * sizeof(float);
  return s;
}
// Training adds the frame's own gates past the end, 4*BU floats, [g][b*U+u]
// (a layout K1's instantiations do not see)
template <bool kTrain>
__host__ __device__ inline size_t smem_bytes(int B, int H, int out, int U, int wbytes) {
  return smem_layout(B, H, out, U, wbytes).total_bytes +
         (kTrain ? 4 * (size_t)B * U * sizeof(float) : 0);
}

// The sums over a warp of the 24 values v = the 3 gates of 8 (row, unit)
// pairs m (v[3m + g]), by recursive halving (27 shuffles where a butterfly
// per value takes 120), in one fixed order: afterwards lanes 4m .. 4m+3 hold
// pair m's three sums in v[0..2].
__device__ __forceinline__ void warp_sum24(float (&v)[24], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const float send = h16 ? v[i] : v[12 + i];
    v[i] = (h16 ? v[12 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float send = h8 ? v[i] : v[6 + i];
    v[i] = (h8 ? v[6 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float send = h4 ? v[i] : v[3 + i];
    v[i] = (h4 ? v[3 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
  }
}

// Whh rows in registers (up to H = 1024): warp w takes the unit pair u0 =
// 2 (w/2), u0 + 1 and one half of H, [512 (w%2), 512 (w%2) + 512); a lane
// holds the 6 rows' float4s at columns col0 + 128 it (wreg[unit][gate][it]),
// so that each float4 of h it loads from shared memory feeds 24 FMAs.  For
// the R batch rows from b0: the products, then the sums over the warp; lane
// 4m stores pair m = (row b0 + m/2, unit u0 + m%2)'s three sums to gh (this
// half's, stride BU between gates) for the np units of the pair that exist.
template <typename W, int R>
__device__ __forceinline__ void whh_pair(const float4 (&wreg)[2][3][kHalfIters], const W* h_s,
                                         int Hs, int H, int b0, int col0, int np, float* gh, int BU,
                                         int U, int bu0) {
  const int lane = threadIdx.x % 32;
  float v[24] = {};  // v[3 (2c + uu) + g]; rows past R stay 0
#pragma unroll
  for (int it = 0; it < kHalfIters; ++it) {
    const int col = col0 + 128 * it;
    if (col < H) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float4 hv = load4(h_s + (size_t)(b0 + c) * Hs + col);
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float& acc = v[3 * (2 * c + uu) + g];
            acc = dot4(wreg[uu][g][it], hv, acc);
          }
      }
    }
  }
  warp_sum24(v, lane);
  const int m = lane / 4, c = m / 2, uu = m % 2;
  if (lane % 4 == 0 && c < R && uu < np) {
    const int bu = bu0 + c * U + uu;
    gh[bu] = v[0];
    gh[BU + bu] = v[1];
    gh[2 * BU + bu] = v[2];
  }
}

// Whh rows in shared memory (H > 1024, or H not a multiple of 4): a warp per
// unit, lanes over H, one butterfly per sum; lane 0 stores the R rows' three
// sums to gh (stride BU between gates).  wr: the unit's r row; its z and n
// rows lie U*H and 2U*H further.
template <typename W, int R>
__device__ __forceinline__ void whh_rows(const W* wr, const W* h_s, int Hs, int H, int U, int b0,
                                         float* gh, int BU, int bu0) {
  const int lane = threadIdx.x % 32;
  const W* wz = wr + (size_t)U * H;
  const W* wn = wz + (size_t)U * H;
  float sr[R] = {}, sz[R] = {}, sn[R] = {};
  if (H % 4 == 0) {  // rows start on 16 (float) or 8 (bf16) bytes
    for (int i = 4 * lane; i < H; i += 128) {
      const float4 w0 = load4(wr + i), w1 = load4(wz + i), w2 = load4(wn + i);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float4 v = load4(h_s + (size_t)(b0 + c) * Hs + i);
        sr[c] = dot4(w0, v, sr[c]);
        sz[c] = dot4(w1, v, sz[c]);
        sn[c] = dot4(w2, v, sn[c]);
      }
    }
  } else {
    for (int i = lane; i < H; i += 32) {
      const float w0 = to_f(wr[i]), w1 = to_f(wz[i]), w2 = to_f(wn[i]);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float v = to_f(h_s[(size_t)(b0 + c) * Hs + i]);
        sr[c] = fmaf(w0, v, sr[c]);
        sz[c] = fmaf(w1, v, sz[c]);
        sn[c] = fmaf(w2, v, sn[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const float s0 = warp_sum(sr[c]), s1 = warp_sum(sz[c]), s2 = warp_sum(sn[c]);
    if (lane == 0) {
      const int bu = bu0 + c * U;
      gh[bu] = s0;
      gh[BU + bu] = s1;
      gh[2 * BU + bu] = s2;
    }
  }
}

// gates_x (r, z, n) and the mask of one (row, unit) at frame t
template <typename W, bool kTrain>
__device__ __forceinline__ float4 stream_load(const Args& a, int b, int j, int t) {
  const W* gx = static_cast<const W*>(a.gx) + ((size_t)b * a.T + t) * 3 * a.H + j;
  float m = 1.f;
  if constexpr (kTrain) m = to_f(static_cast<const W*>(a.mask)[((size_t)b * a.T + t) * a.H + j]);
  return make_float4(to_f(gx[0]), to_f(gx[a.H]), to_f(gx[2 * a.H]), m);
}
__device__ __forceinline__ void stream_store(float* gxs, int BU, int pr, float4 v) {
  gxs[pr] = v.x;
  gxs[BU + pr] = v.y;
  gxs[2 * BU + pr] = v.z;
  gxs[3 * BU + pr] = v.w;
}

// Training: the gates of frame t staged in gs (r, z, n, gh_n of every own
// (row, unit), [g][b*U+u]) to gates (B, T, 4, H).  Thread kThreads-1-i takes
// (row, unit) i, so that warp 0, which sums the y slice, has none while
// B*U <= 224.
__device__ __forceinline__ void gates_store(const Args& a, const float* gs, int t, int BU, int U,
                                            int nu, int j0) {
  for (int pr = kThreads - 1 - (int)threadIdx.x; pr < BU; pr += kThreads) {
    const int b = pr / U, u = pr % U;
    if (u >= nu) continue;
    float* g = a.gates + ((size_t)b * a.T + t) * 4 * a.H + j0 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) __stcs(g + (size_t)q * a.H, gs[q * BU + pr]);
  }
}

// This block's slice of y, [k*S, k*S+S) of the padded B*Ys values, from
// the G blocks' partials at src ([kk][S], in L2): warp w takes the columns of
// 4 values c = w, w+8, ..., its lanes over the partials.  slice_load loads a
// column's first kRS float4s a lane (G <= 128: all of them), issued so that
// they travel with the copy of h.  sum_column adds them in one fixed order
// (kk = lane, lane+32, ...), sums the four values over the warp by recursive
// halving (after which lane 8e holds value e), adds b_out and calls emit(idx,
// b, o, y) in lane 8e for value idx = k*S + 4c + e, with its row and column
// (b < 0 for a pad, whose partials nobody writes: y = 0); the caller gives
// (b, o) of that value.
constexpr int kRS = 4;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void slice_load(const float* src, int S, int c, float4 (&v)[kRS]) {
  const int G = gridDim.x, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kRS; ++j) {
    const int kk = lane + 32 * j;
    v[j] = kk < G ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)kk * S + 4 * c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename Emit>
__device__ __forceinline__ void sum_column(const Args& a, int c, int b, int o, const float* src,
                                           const float4 (&v)[kRS], const float* bout_s, Emit emit) {
  const int G = gridDim.x, S = a.S, lane = threadIdx.x % 32;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kRS; ++j) acc = add4(acc, v[j]);
  for (int kk = lane + 32 * kRS; kk < G; kk += 32)  // more than 128 blocks only
    acc = add4(acc, __ldcg(reinterpret_cast<const float4*>(src + (size_t)kk * S + 4 * c)));
  const bool h16 = lane & 16, h8 = lane & 8;
  const float lo = (h16 ? acc.z : acc.x) + __shfl_xor_sync(0xffffffffu, h16 ? acc.x : acc.z, 16);
  const float hi = (h16 ? acc.w : acc.y) + __shfl_xor_sync(0xffffffffu, h16 ? acc.y : acc.w, 16);
  float y = (h8 ? hi : lo) + __shfl_xor_sync(0xffffffffu, h8 ? lo : hi, 8);
  y += __shfl_xor_sync(0xffffffffu, y, 4);
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  const int idx = blockIdx.x * S + 4 * c + lane / 8;
  if (lane % 8 == 0 && idx < a.YW) {
    if (o < a.out)
      emit(idx, b, o, y + bout_s[o]);
    else
      emit(idx, -1, -1, 0.f);
  }
}

// All of this block's slice: the first column of warp w (its loads issued by
// the caller, in first; the row and column of lane 8e's value in b0, o0),
// then its further columns c = w+8, ... (S > 32 only)
template <typename Emit>
__device__ __forceinline__ void sum_slice(const Args& a, const float* src,
                                          const float4 (&first)[kRS], int b0, int o0,
                                          const float* bout_s, Emit emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sum_column(a, warp, b0, o0, src, first, bout_s, emit);
  for (int c = warp + kWarps; c < a.S / 4; c += kWarps) {
    float4 v[kRS];
    slice_load(src, a.S, c, v);
    const int idx = blockIdx.x * a.S + 4 * c + lane / 8;
    sum_column(a, c, idx / a.Ys, idx % a.Ys, src, v, bout_s, emit);
  }
}

template <typename W, bool kTrain>
__global__ void __launch_bounds__(kThreads) gru_ar_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, OUT = a.out, U = a.U, Hs = a.Hs, Ys = a.Ys, S = a.S;
  const int G = gridDim.x, k = blockIdx.x, j0 = k * U, BU = B * U, YW = a.YW, gl = a.lanes;
  const int nu = max(0, min(U, H - j0));  // units this block owns (last block may be ragged)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Smem L = smem_layout(B, H, OUT, U, sizeof(W));
  const bool regs = whh_in_regs(H, U);
  const bool owner = k < a.owners;
  const int Ws = w_row(OUT, sizeof(W));

  W* h_s = reinterpret_cast<W*>(smem + L.h);
  float* y_s = smem + L.y;
  float* bout_s = smem + L.bout;
  float* gh_s = smem + L.gh;
  float* gx_s = smem + L.gx;
  float* hn_s = smem + L.hn;
  float* hown_s = smem + L.hown;
  float* bhh_s = smem + L.bhh;
  float* gs_s = smem + L.total_bytes / sizeof(float);  // training only
  W* whh_s = reinterpret_cast<W*>(smem + L.whh);  // row g*U + u: gate g of unit j0+u
  W* wy_s = reinterpret_cast<W*>(smem + L.wy);    // the same rows
  W* wout_s = reinterpret_cast<W*>(smem + L.wout);

  const W* wy = static_cast<const W*>(a.wy);
  const W* whh = static_cast<const W*>(a.whh);
  const W* wout = static_cast<const W*>(a.wout);
  W* hbuf = static_cast<W*>(a.hbuf);
  W* hseq = static_cast<W*>(a.hseq);
  unsigned* count1 = reinterpret_cast<unsigned*>(a.ybuf + count_word(YW));  // blocks arrived

  // ---- weights into registers and shared memory, the initial state ----
  // regs: warp w holds units u0, u0+1 over half hf of H (whh_pair)
  const int u0 = 2 * (warp / 2), hf = warp % 2, col0 = 128 * kHalfIters * hf + 4 * lane;
  float4 wreg[2][3][kHalfIters];
  if (regs) {
#pragma unroll
    for (int uu = 0; uu < 2; ++uu)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int it = 0; it < kHalfIters; ++it) {
          const int u = u0 + uu, i = col0 + 128 * it;
          wreg[uu][g][it] = u < nu && i < H ? load4(whh + (size_t)(g * H + j0 + u) * H + i)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
  } else {
    for (int idx = threadIdx.x; idx < 3 * U * H; idx += kThreads) {
      const int r = idx / H, i = idx % H, g = r / U, u = r % U;
      whh_s[idx] = u < nu ? whh[(size_t)(g * H + j0 + u) * H + i] : from_f<W>(0.f);
    }
  }
  for (int idx = threadIdx.x; idx < 3 * U * Ws; idx += kThreads) {
    const int r = idx / Ws, o = idx % Ws, g = r / U, u = r % U;
    wy_s[idx] = u < nu && o < OUT ? wy[(size_t)(g * H + j0 + u) * OUT + o] : from_f<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < U * Ws; idx += kThreads) {
    const int u = idx / Ws, o = idx % Ws;
    wout_s[idx] = u < nu && o < OUT ? wout[(size_t)o * H + j0 + u] : from_f<W>(0.f);
  }
  for (int r = threadIdx.x; r < 3 * U; r += kThreads) {
    const int g = r / U, u = r % U;
    bhh_s[r] = u < nu ? a.bhh[g * H + j0 + u] : 0.f;
  }
  for (int idx = threadIdx.x; idx < B * Hs; idx += kThreads) {
    const int b = idx / Hs, i = idx % Hs;
    h_s[idx] = from_f<W>(i < H ? a.h0[(size_t)b * H + i] : 0.f);
  }
  for (int idx = threadIdx.x; idx < YW; idx += kThreads) {
    const int b = idx / Ys, o = idx % Ys;
    y_s[idx] = o < OUT ? round_w<W>(a.y0[b * OUT + o]) : 0.f;
  }
  for (int o = threadIdx.x; o < Ys; o += kThreads) bout_s[o] = o < OUT ? a.bout[o] : 0.f;
  for (int i = threadIdx.x; i < 6 * BU; i += kThreads) gh_s[i] = 0.f;  // half 1: 0 without regs
  for (int pr = threadIdx.x; pr < BU; pr += kThreads) {
    const int b = pr / U, u = pr % U;
    hown_s[pr] = u < nu ? a.h0[(size_t)b * H + j0 + u] : 0.f;
    if (u < nu) stream_store(gx_s, BU, pr, stream_load<W, kTrain>(a, b, j0 + u, 0));
  }

  // per-thread roles, fixed for the call (no integer division in the loop
  // at the main path's shapes)
  const int pr0 = threadIdx.x / gl, q = threadIdx.x % gl;  // gate phase: (row, unit) pr0, lane q
  const int pb0 = pr0 / U, pu0 = pr0 % U;
  const int fb = threadIdx.x / U, fu = threadIdx.x % U;    // the streams of (row, unit) threadIdx.x
  // the y partial: values threadIdx.x and threadIdx.x + 256 of the B*out,
  // their row, column and place among the partials (pads are not written)
  const int BO = B * OUT;
  auto place = [&](int i) {
    const int at = i / OUT * Ys + i % OUT;
    return ((size_t)(at / S) * G + k) * S + at % S;
  };
  const int ya = threadIdx.x, yc = threadIdx.x + kThreads;
  const int ya_b = ya / OUT, ya_o = ya % OUT, yc_b = yc / OUT, yc_o = yc % OUT;
  const size_t ya_at = place(ya), yc_at = place(yc);
  // the slice value this thread emits in the reduce-scatter (lane 8e of warp w: k*S + 4w + e)
  const int rs_idx = k * S + 4 * warp + lane / 8, rs_b = rs_idx / Ys, rs_o = rs_idx % Ys;
  __syncthreads();

#ifdef GRU_AR_PROFILE
  long long prof_acc[kPhases] = {}, prof_t = clock64();
#endif
  for (int t = 0; t < T; ++t) {
    const int p = t & 1, pq = p ^ 1;  // this frame's buffers; the previous frame's
    const unsigned tag = (unsigned)t;

    // the next frame's streamed gates and mask: in flight through the frame
    float4 nxt = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool pf = t + 1 < T && threadIdx.x < BU && fu < nu;
    if (pf) nxt = stream_load<W, kTrain>(a, fb, j0 + fu, t + 1);

    if (t > 0) {
      // ---- hop 1: h_{t-1} and this block's slice of the y_{t-1} partials ----
      if (threadIdx.x == 0) wait_acquire(count1, (unsigned)G * t);
      __syncthreads();
      PROF_MARK(0);
      const W* hsrc = hbuf + (size_t)pq * B * Hs;
      const int hq = B * Hs * (int)sizeof(W) / 16;
      for (int c = threadIdx.x; c < hq; c += kThreads)
        cp_async16(reinterpret_cast<char*>(h_s) + 16 * c,
                   reinterpret_cast<const char*>(hsrc) + 16 * c);
      if constexpr (kTrain) gates_store(a, gs_s, t - 1, BU, U, nu, j0);  // while warp 0 sums
      // ---- hop 2 out, while h is copied: the slice summed, stored with its
      // tag, trj[:, t-1] ----
      if (owner && warp < S / 4) {
        const float* psrc = a.ypart + ((size_t)pq * G + k) * G * S;
        float4 first[kRS];
        slice_load(psrc, S, warp, first);
        unsigned long long* ydst = a.ybuf + (size_t)pq * YW;
        sum_slice(a, psrc, first, rs_b, rs_o, bout_s, [&](int idx, int b, int o, float y) {
          store_tagged(ydst + idx, y, tag);
          if (b >= 0) a.trj[((size_t)b * T + t - 1) * OUT + o] = y;
        });
      }
      cp_async_wait_all();
      __syncthreads();
      PROF_MARK(1);
    }

    // ---- Whh . h_{t-1} while y_{t-1} travels ----
    if (regs) {
      if (u0 < nu) {
        const int np = min(2, nu - u0);
        float* gh = gh_s + (size_t)hf * 3 * BU;
        for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
          const int bu0 = b0 * U + u0;
          switch (min(kBatchChunk, B - b0)) {
            case 1: whh_pair<W, 1>(wreg, h_s, Hs, H, b0, col0, np, gh, BU, U, bu0); break;
            case 2: whh_pair<W, 2>(wreg, h_s, Hs, H, b0, col0, np, gh, BU, U, bu0); break;
            case 3: whh_pair<W, 3>(wreg, h_s, Hs, H, b0, col0, np, gh, BU, U, bu0); break;
            default: whh_pair<W, 4>(wreg, h_s, Hs, H, b0, col0, np, gh, BU, U, bu0); break;
          }
        }
      }
    } else {
      for (int u = warp; u < nu; u += kWarps) {
        const W* wr = whh_s + (size_t)u * H;
        for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
          const int bu0 = b0 * U + u;
          switch (min(kBatchChunk, B - b0)) {
            case 1: whh_rows<W, 1>(wr, h_s, Hs, H, U, b0, gh_s, BU, bu0); break;
            case 2: whh_rows<W, 2>(wr, h_s, Hs, H, U, b0, gh_s, BU, bu0); break;
            case 3: whh_rows<W, 3>(wr, h_s, Hs, H, U, b0, gh_s, BU, bu0); break;
            default: whh_rows<W, 4>(wr, h_s, Hs, H, U, b0, gh_s, BU, bu0); break;
          }
        }
      }
    }
    float* gx_next = gx_s + (size_t)(p ^ 1) * 4 * BU;
    if (pf) stream_store(gx_next, BU, threadIdx.x, nxt);
    if (t + 1 < T)
      for (int pr = threadIdx.x + kThreads; pr < BU; pr += kThreads) {  // B*U > 256 only
        const int b = pr / U, u = pr % U;
        if (u < nu) stream_store(gx_next, BU, pr, stream_load<W, kTrain>(a, b, j0 + u, t + 1));
      }
    PROF_MARK(2);

    // ---- hop 2 in: y_{t-1} from the tagged words ----
    if (t > 0) {
      const unsigned long long* ysrc = a.ybuf + (size_t)pq * YW;
      for (int pi = threadIdx.x; pi < YW / 2; pi += kThreads) {
        const long long start = clock64();
        ulonglong2 w;
        for (;;) {
          w = load_tagged2(ysrc + 2 * pi);
          if (tag_of(w.x) == tag && tag_of(w.y) == tag) break;
          spin_guard(start);
        }
        y_s[2 * pi] = round_w<W>(value_of(w.x));
        y_s[2 * pi + 1] = round_w<W>(value_of(w.y));
      }
    }
    __syncthreads();
    PROF_MARK(3);

    // ---- Wy . y_{t-1}, the gates and h_t: gl lanes per (row, unit) ----
    const float* gx_cur = gx_s + (size_t)p * 4 * BU;
    for (int base = 0; base < BU; base += kThreads / gl) {  // the same trip count in every thread
      const int pr = base + pr0;
      const int b = base == 0 ? pb0 : pr / U, u = base == 0 ? pu0 : pr % U;
      const bool act = pr < BU && u < nu;
      float ar = 0.f, az = 0.f, an = 0.f;
      if (act) {
        const float* yr = y_s + (size_t)b * Ys;
        const W* w0 = wy_s + (size_t)u * Ws;
        const W* w1 = w0 + (size_t)U * Ws;
        const W* w2 = w1 + (size_t)U * Ws;
        for (int o = 4 * q; o < OUT; o += 4 * gl) {
          const float4 v = *reinterpret_cast<const float4*>(yr + o);
          ar = dot4(load4(w0 + o), v, ar);
          az = dot4(load4(w1 + o), v, az);
          an = dot4(load4(w2 + o), v, an);
        }
      }
      for (int off = gl / 2; off > 0; off >>= 1) {
        ar += __shfl_xor_sync(0xffffffffu, ar, off);
        az += __shfl_xor_sync(0xffffffffu, az, off);
        an += __shfl_xor_sync(0xffffffffu, an, off);
      }
      if (act && q == 0) {
        const int j = j0 + u;
        const float* gh1 = gh_s + 3 * BU;  // the second half of H
        const float ghr = gh_s[pr] + gh1[pr], ghz = gh_s[BU + pr] + gh1[BU + pr];
        const float ghn = gh_s[2 * BU + pr] + gh1[2 * BU + pr];
        const float rg = sigmoid_f(gx_cur[pr] + ((ghr + ar) + bhh_s[u]));
        const float zg = sigmoid_f(gx_cur[BU + pr] + ((ghz + az) + bhh_s[U + u]));
        const float ng = tanhf((gx_cur[2 * BU + pr] + an) + rg * (ghn + bhh_s[2 * U + u]));
        const float hnew = (1.f - zg) * ng + zg * hown_s[pr];
        hown_s[pr] = hnew;
        hbuf[((size_t)p * B + b) * Hs + j] = from_f<W>(hnew);
        if constexpr (kTrain) {
          hseq[((size_t)b * T + t) * H + j] = from_f<W>(hnew);
          hn_s[pr] = round_w<W>(hnew * gx_cur[3 * BU + pr]);
          gs_s[pr] = rg;
          gs_s[BU + pr] = zg;
          gs_s[2 * BU + pr] = ng;
          gs_s[3 * BU + pr] = ghn + bhh_s[2 * U + u];
        } else {
          hn_s[pr] = round_w<W>(hnew);
        }
      }
    }
    __syncthreads();
    PROF_MARK(4);

    // ---- this block's partial of y_t over its units, by destination slice ----
    float* part = a.ypart + (size_t)p * G * G * S;
    auto partial = [&](int b, int o, size_t at) {
      const float* hn = hn_s + b * U;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < kWarps; ++u)  // unrolled: the loads go out together
        if (u < nu) s = fmaf(hn[u], to_f(wout_s[u * Ws + o]), s);
      for (int u = kWarps; u < nu; ++u) s = fmaf(hn[u], to_f(wout_s[u * Ws + o]), s);
      __stcg(part + at, s);
    };
    if (ya < BO) partial(ya_b, ya_o, ya_at);
    if (yc < BO) partial(yc_b, yc_o, yc_at);
    for (int r = yc + kThreads; r < BO; r += kThreads)  // B*out > 512 only
      partial(r / OUT, r % OUT, place(r));
    PROF_MARK(5);
    __syncthreads();
    if (threadIdx.x == 0) arrive_release(count1);
    PROF_MARK(6);
  }
#ifdef GRU_AR_PROFILE
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_prof[i] += prof_acc[i];
#endif

  // ---- the last frame's h (each block its units), gates and y (each block its slice) ----
  if constexpr (kTrain) gates_store(a, gs_s, T - 1, BU, U, nu, j0);
  for (int pr = threadIdx.x; pr < BU; pr += kThreads) {
    const int b = pr / U, u = pr % U;
    if (u < nu) a.h_last[(size_t)b * H + j0 + u] = hown_s[pr];
  }
  if (owner) {
    if (threadIdx.x == 0) wait_acquire(count1, (unsigned)G * T);
    __syncthreads();
    if (warp < S / 4) {
      const float* psrc = a.ypart + ((size_t)((T - 1) & 1) * G + k) * G * S;
      float4 first[kRS];
      slice_load(psrc, S, warp, first);
      sum_slice(a, psrc, first, rs_b, rs_o, bout_s, [&](int, int b, int o, float y) {
        if (b < 0) return;
        a.trj[((size_t)b * T + T - 1) * OUT + o] = y;
        a.y_last[b * OUT + o] = y;
      });
    }
  }
}

// y values each block sums: B*Ys over the G blocks, rounded up to 4
inline int y_slice(int B, int out, int G) { return (int)up4(((size_t)B * up4(out) + G - 1) / G); }

// lanes per (row, unit) in the gate phase: the most of 8, 4, 2 that keep
// every (row, unit) in one pass of the block's threads
inline int gate_lanes(int B, int U) {
  int gl = 8;
  while (gl > 1 && (long long)B * U * gl > kThreads) gl /= 2;
  return gl;
}

// The kernel may use up to the device's opt-in shared memory per block: set
// once per device, by the plan or by the first launch there.
template <typename W, bool kTrain>
cudaError_t allow_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_ar_kernel<W, kTrain>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <typename W, bool kTrain>
int plan(int B, int H, int out, int* grid, int* units, int* slice, int* lanes, int* smem) {
  if (B < 1 || H < 1 || out < 1) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e == cudaSuccess) e = allow_smem<W, kTrain>();
  if (e != cudaSuccess) return e;
  // fewest units per block (most blocks) whose grid is co-resident
  for (int U = (H + sms - 1) / sms; U <= H; ++U) {
    const int G = (H + U - 1) / U;
    const size_t s = smem_bytes<kTrain>(B, H, out, U, sizeof(W));
    if (s > (size_t)optin) continue;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gru_ar_kernel<W, kTrain>, kThreads, s);
    if (e != cudaSuccess) return e;
    if ((long long)occ * sms >= G) {
      *grid = G;
      *units = U;
      *slice = y_slice(B, out, G);
      *lanes = gate_lanes(B, U);
      *smem = (int)s;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // B rows of h do not fit in shared memory
}

template <typename W, bool kTrain>
int launch(const void* gx, const void* wy, const void* whh, const void* bhh, const void* wout,
           const void* bout, const void* y0, const void* h0, const void* mask, void* trj,
           void* y_last, void* h_last, void* hseq, void* gates, void* hbuf, void* ypart,
           void* ybuf, int B, int T, int H, int out, int grid, int units, int slice, int lanes,
           int smem, void* stream) {
  const int Ys = (int)up4(out), YW = B * Ys;
  if (B < 1 || T < 1 || H < 1 || out < 1 || units < 1 || (long long)grid * units < H ||
      slice < 4 || slice % 4 || (long long)grid * slice < YW || (lanes & (lanes - 1)) ||
      lanes < 1 || lanes > 8 || (lanes > 1 && (long long)B * units * lanes > kThreads) ||
      (kTrain && (mask == nullptr || hseq == nullptr || gates == nullptr)))
    return cudaErrorInvalidValue;
  Args a{gx, wy, whh, static_cast<const float*>(bhh), wout, static_cast<const float*>(bout),
         static_cast<const float*>(y0), static_cast<const float*>(h0), mask,
         static_cast<float*>(trj), static_cast<float*>(y_last), static_cast<float*>(h_last), hseq,
         hbuf, static_cast<float*>(ypart), static_cast<unsigned long long*>(ybuf), B, T, H, out,
         units, w_row(H, sizeof(W)), Ys, YW, slice, (YW + slice - 1) / slice, lanes,
         static_cast<float*>(gates)};
  cudaError_t e = allow_smem<W, kTrain>();
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

// blocks, units per block, y values each block sums, lanes per (row, unit)
// in the gate phase and dynamic shared bytes for one call
int gru_ar_plan_f32(int B, int H, int out, int* grid, int* units, int* slice, int* lanes,
                    int* smem) {
  return plan<float, false>(B, H, out, grid, units, slice, lanes, smem);
}
int gru_ar_plan_bf16(int B, int H, int out, int* grid, int* units, int* slice, int* lanes,
                     int* smem) {
  return plan<__nv_bfloat16, false>(B, H, out, grid, units, slice, lanes, smem);
}
int gru_ar_train_plan_f32(int B, int H, int out, int* grid, int* units, int* slice, int* lanes,
                          int* smem) {
  return plan<float, true>(B, H, out, grid, units, slice, lanes, smem);
}
int gru_ar_train_plan_bf16(int B, int H, int out, int* grid, int* units, int* slice, int* lanes,
                           int* smem) {
  return plan<__nv_bfloat16, true>(B, H, out, grid, units, slice, lanes, smem);
}

// Scratch, none initialised but ybuf: hbuf (2, B, Hs) at the weight type, Hs
// being H rounded up to whole 16-byte pieces; ypart (2, grid, grid, slice)
// floats; ybuf 8-byte words, zeroed: 2 * YW tagged words (YW = B * Ys, Ys =
// out rounded up to 4), rounded up to a multiple of 16, then 16 words, the
// first of which holds the frame count
int gru_ar_f32(const void* gx, const void* wy, const void* whh, const void* bhh, const void* wout,
               const void* bout, const void* y0, const void* h0, void* trj, void* y_last,
               void* h_last, void* hbuf, void* ypart, void* ybuf, int B, int T, int H, int out,
               int grid, int units, int slice, int lanes, int smem, void* stream) {
  return launch<float, false>(gx, wy, whh, bhh, wout, bout, y0, h0, nullptr, trj, y_last, h_last,
                              nullptr, nullptr, hbuf, ypart, ybuf, B, T, H, out, grid, units,
                              slice, lanes, smem, stream);
}
int gru_ar_bf16(const void* gx, const void* wy, const void* whh, const void* bhh, const void* wout,
                const void* bout, const void* y0, const void* h0, void* trj, void* y_last,
                void* h_last, void* hbuf, void* ypart, void* ybuf, int B, int T, int H, int out,
                int grid, int units, int slice, int lanes, int smem, void* stream) {
  return launch<__nv_bfloat16, false>(gx, wy, whh, bhh, wout, bout, y0, h0, nullptr, trj, y_last,
                                      h_last, nullptr, nullptr, hbuf, ypart, ybuf, B, T, H, out,
                                      grid, units, slice, lanes, smem, stream);
}

// training forward: mask (B, T, H) in, h_seq (B, T, H) out, both at the
// weight type, and gates (B, T, 4, H) out, float: r, z, n and gh_n (with
// b_hh's n row) of every frame; the rest as gru_ar_*
int gru_ar_train_f32(const void* gx, const void* wy, const void* whh, const void* bhh,
                     const void* wout, const void* bout, const void* y0, const void* h0,
                     const void* mask, void* trj, void* y_last, void* h_last, void* hseq,
                     void* gates, void* hbuf, void* ypart, void* ybuf, int B, int T, int H,
                     int out, int grid, int units, int slice, int lanes, int smem, void* stream) {
  return launch<float, true>(gx, wy, whh, bhh, wout, bout, y0, h0, mask, trj, y_last, h_last,
                             hseq, gates, hbuf, ypart, ybuf, B, T, H, out, grid, units, slice,
                             lanes, smem, stream);
}
int gru_ar_train_bf16(const void* gx, const void* wy, const void* whh, const void* bhh,
                      const void* wout, const void* bout, const void* y0, const void* h0,
                      const void* mask, void* trj, void* y_last, void* h_last, void* hseq,
                      void* gates, void* hbuf, void* ypart, void* ybuf, int B, int T, int H,
                      int out, int grid, int units, int slice, int lanes, int smem, void* stream) {
  return launch<__nv_bfloat16, true>(gx, wy, whh, bhh, wout, bout, y0, h0, mask, trj, y_last,
                                     h_last, hseq, gates, hbuf, ypart, ybuf, B, T, H, out, grid,
                                     units, slice, lanes, smem, stream);
}

#ifdef GRU_AR_PROFILE
int gru_ar_profile_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[kPhases] = {};
  return cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
