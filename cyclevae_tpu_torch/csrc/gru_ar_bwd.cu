// Reverse-time cotangent scan of the autoregressive GRU (the training
// backward, K3) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel cyclevae_tpu/ops/pallas_gru.py:_kernel_bwd
// (wrapper pallas_gru_ar_bwd).  For t = T-1 down to 0, with the carries dh
// (B, H) and dy (B, out) starting at dh_T and dy_T:
//   the gates  r, z, n and ghn = gh_n of step t: the forward's (K2 keeps them),
//              or recomputed: gx = gates_x[t] + y_prev[t] . Wy^T,
//              gh = h_prev[t] . Whh^T + b_hh, r, z, n as in the forward
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
// What bounds it on this card: the latency of one reversed step times T, not
// bytes or FLOPs (a dec-2B call, B=10, T=80, moves ~40 MB and does ~10
// GFLOP).  Each step crosses blocks twice: dh needs a sum over all 3H rows
// of dgh, dy one over all 3H rows of dgx.  The design keeps what must cross
// small and what need not wait out of the step loop:
//   * ONE cooperative launch; block k owns hidden units [kU, kU+U) and so 3U
//     gate rows (U = 8, 128 blocks at H = 1024).  Its 3U rows of Whh and of
//     Wy and its U columns of Wout sit in shared memory.
//   * The gates need no carry.  The training forward (K2) keeps r, z, n and
//     ghn of every (row, step, unit) in float, (B, T, 4, H); each step copies
//     its block's share, 1 KB at B=8, one step ahead (cp.async), and h_prev
//     and mask ride their own streams into registers, one step ahead too.
//     A caller that holds no such gates has them recomputed for ALL steps
//     before the step loop (gates_all), into the same layout in scratch, as
//     one product per block: (B*T rows of h_prev) x (its 3U Whh rows), tiles
//     of h_prev copied with cp.async (double-buffered), each thread 4 rows x
//     4 units' 12 gate rows (16 loads from shared memory feed 192 FMAs); then
//     y_prev . Wy and the gate nonlinearity, through shared memory to threads
//     that run over units, so that the streamed gates_x loads and the stores
//     coalesce.  Inside the loop that work ran as short latency-bound bursts
//     (~10K cycles a step on an H100); before it, every block reading all of
//     h_prev makes it run at the L2's read rate instead (~6.4K cycles a step
//     at B=10, T=560); read from the forward, it costs nothing of the step.
//   * dh without a gather: after the cotangent algebra of its units, block kk
//     multiplies its own dgh (B, 3U) by its own rows of Whh, a partial of dh
//     for ALL H columns, and writes it laid out by the block that owns each
//     column.  Block k then reads its (G, B, U) partials as one contiguous
//     region (40 KB at B=10) and sums them in a fixed order.  So no block
//     copies dgh (B, 3H), and the dh product needs no Whh columns.
//   * dy by reduce-scatter: block kk also writes its partial of dy over its
//     3U rows (B*out values).  Block k sums its slice of ~B*out/G values over
//     the G partials (a fixed order: lanes over the partials, then a
//     butterfly) and stores the sums as step-tagged 8-byte words; every block
//     polls the B*out words of dy.  Per step a block reads ~2 KB of dy
//     partials and ~4 KB of tagged words where it read all G partials (256 KB
//     at B=10).  The dh partials are copied (cp.async) and summed while this
//     second hop travels.
//   * No grid barrier.  Hop 1 (the partials): after its writes and a
//     __syncthreads(), one thread per block adds to a step count with
//     release semantics; readers wait on it with acquire (one thread, then
//     __syncthreads()) and read through L2.  Hop 2 (dy): tagged words, the
//     tags decide; a relaxed count of the blocks that stored is only a hint
//     that keeps 128 blocks from polling L2 at once (as K4).  Buffers double
//     by step parity: a block writes step s+2's partials only after every
//     block has arrived at step s+1, so after all reads of step s's.
//   * Every sum runs in a fixed order and no atomic touches a value: two
//     launches give bitwise equal outputs.  Every spin traps after 2^36
//     cycles (exchange.cuh).
// No tensor cores: float weights must not round to TF32, and B is 5-10.
// No thread-block clusters: a cluster could halve the dh partials' L2
// traffic, but their stores cost ~1K of the ~6K cycles of the partial
// product on an H100 (a build that skipped them), less than a third hop
// through distributed shared memory would add.  The plan raises for a shape
// whose B rows do not fit; it never falls back.
//
// Built with -DGRU_AR_BWD_PROFILE, thread 0 of block 0 sums the SM cycles
// each phase of a step takes, and those of the gate recompute before the
// loop, or of the first step's copy where the gates are given
// (gru_ar_bwd_profile_read; ops/gru_ar_bwd_phases.py names and prints them;
// each PROF_MARK(i) closes phase i).

#include "exchange.cuh"
#include "gru_common.cuh"

namespace {

using namespace gru;

constexpr int kPB = 10;  // batch rows the partial product of dh accumulates at once
// the gate recompute: a thread takes kGR rows (b, t) of h_prev and kGU units
// (3 kGU gate rows); kRG threads share each unit group
constexpr int kGR = 4, kGU = 4, kRG = kThreads / 2;
constexpr int kMT = kGR * kRG;  // rows of h_prev in one tile
constexpr int kKC = 16;         // columns of a tile copied at once
constexpr int kGates = 4;       // per (row, step, unit): r, z, n, ghn

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
  float* gates;        // (B, T, 4, H) r, z, n, ghn of every (row, step, unit): the forward's,
                       //   or scratch that gates_all fills
  float* pbuf;         // (2, G, G, B, Us) scratch: [p][dest][kk] block kk's partial of dh
                       //   for block dest's units
  float* dbuf;         // (2, G, DS) scratch: [p][kk] block kk's partial of dy
  unsigned long long* ybuf;  // (2, YW) tagged words of dy, then the two step counts; zeroed
  int B, T, H, out, U;
  int Hs, Rs, Us, Bp;  // H rounded up to 4; the Whh rows' stride in shared memory (Hs + 16
                       //   bytes); U and B rounded up to 4
  int S, DS, YW;       // dy values a block sums (a multiple of 4), G*S, B*out rounded up to even
  int stage_kk;        // dh partials (of the G) copied per pass
  int recompute;       // whether gates_all fills gates first
  int vec;             // whether each row's units of gates are whole 16-byte pieces
};

#ifdef GRU_AR_BWD_PROFILE
constexpr int kPhases = 8;
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

// floats that n values of wbytes each take, rounded up to 16 bytes
__host__ __device__ inline size_t wfloats(size_t n, int wbytes) { return up4((n * wbytes + 3) / 4); }

__host__ __device__ inline int row_stride(int H, int wbytes) { return (int)up4(H) + 16 / wbytes; }
__host__ __device__ inline int tile_stride(int wbytes) { return kKC + 16 / wbytes; }

struct Smem {  // offsets in floats; every array starts on 16 bytes
  size_t stage, tile, dtr, dyt, gate, dh, dhz, dgh, dgx, red, bhh, rows, wy, wout, total_bytes;
};

__host__ __device__ inline Smem smem_layout(int B, int H, int out, int U, int stage_kk, int wbytes) {
  const size_t R = 3 * (size_t)U, Us = up4(U), Bp = up4(B), BO = up4((size_t)B * out);
  Smem s;
  // one region, used first by the gate recompute (two tiles of h_prev; then
  // y_prev of kRG rows and their sums) and then by the step loop (a pass of
  // dh partials)
  s.stage = 0;                                             // stage_kk*B*Us  dh partials
  s.tile = 0;                                              // 2*kMT*tile_stride  W
  const size_t pass = (size_t)stage_kk * B * Us;
  const size_t tiles = wfloats(2 * (size_t)kMT * tile_stride(wbytes), wbytes);
  const size_t rows_y = wfloats((size_t)kRG * out, wbytes) + (size_t)kRG * 2 * kGU * 4;
  size_t region = pass > tiles ? pass : tiles;
  region = region > rows_y ? region : rows_y;
  s.dtr = region;                               // B*out    d_trj[t]
  s.dyt = s.dtr + BO;                           // B*out+1  dy_tot (even length)
  s.gate = s.dyt + up4((size_t)B * out + 1);    // 4*B*Us   the step's gates, [b][q][u]
  s.dh = s.gate + kGates * (size_t)B * Us;      // B*U      own dh carry
  s.dhz = s.dh + up4((size_t)B * U);            // B*U      own dh_tot * z
  s.dgh = s.dhz + up4((size_t)B * U);           // 3U*Bp    own dgh rounded to W, [row][b]
  s.dgx = s.dgh + R * Bp;                       // 3U*Bp    own dgx rounded to W, [row][b]
  s.red = s.dgx + R * Bp;                       // partial sums of the dh partials
  s.bhh = s.red + (B * U > kThreads ? up4((size_t)B * U) : (size_t)kThreads);  // 3U  b_hh rows
  s.rows = s.bhh + up4(R);                      // 3U*Rs W  own rows of Whh, zero padded
  s.wy = s.rows + wfloats(R * row_stride(H, wbytes), wbytes);  // 3U*out W  own rows of Wy
  s.wout = s.wy + wfloats(R * out, wbytes);                    // U*out  W  [u][o] = Wout[o][j0+u]
  s.total_bytes = (s.wout + wfloats((size_t)U * out, wbytes)) * sizeof(float);
  return s;
}

template <typename W>
struct Ptrs {
  float *stage, *dtr, *dyt, *gate, *dh, *dhz, *dgh, *dgx, *red, *bhh;
  W *tile, *rows, *wy, *wout;
};

// 4-byte asynchronous copy global -> shared (through L1), and cp.async groups
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [kc*kKC, kc*kKC + kKC) of h_prev's rows m0 .. m0+kMT-1 into tile
// buffer buf: 16-byte cp.async pieces where every row is a whole number of
// pieces (rows past M are not copied), else plain loads (rows past M repeat
// row M-1, columns past H are 0)
template <typename W>
__device__ __forceinline__ void tile_copy(const Args& a, const Ptrs<W>& P, int m0, int kc, int buf) {
  const W* h = static_cast<const W*>(a.hprev);
  const int M = a.B * a.T, H = a.H, ts = tile_stride(sizeof(W));
  W* dst = P.tile + (size_t)buf * kMT * ts;
  if (H % kKC == 0) {
    constexpr int per = kKC * (int)sizeof(W) / 16, vals = 16 / (int)sizeof(W);
    const int rows = min(kMT, M - m0);  // rows past M keep stale values, never stored
    for (int c = threadIdx.x; c < rows * per; c += kThreads) {
      const int r = c / per, x = c % per;
      cp_async16(dst + (size_t)r * ts + x * vals, h + (size_t)(m0 + r) * H + kc * kKC + x * vals);
    }
  } else {
    for (int c = threadIdx.x; c < kMT * kKC; c += kThreads) {
      const int r = c / kKC, x = c % kKC, m = min(m0 + r, M - 1), col = kc * kKC + x;
      dst[(size_t)r * ts + x] = col < H ? h[(size_t)m * H + col] : from_f<W>(0.f);
    }
  }
}

// The gates of every (row, step, own unit) where the caller gives none,
// before the step loop, as one product per block of the B*T rows m = b*T +
// t of h_prev with its 3U Whh rows.  Tiles of kMT rows, in another order in
// each block (so that the blocks do not all read the same lines at once);
// thread (qg, rg) takes rows m0 + rg + kRG*j (j < kGR) and units qg*kGU + uu
// (uu < kGU; + 8, 16, ... past 8 units), all 3 gates: kGR + 3 kGU loads from
// shared memory feed 12 kGR kGU FMAs.  h_prev streams through
// double-buffered tiles of kKC columns (cp.async); then, per block of kRG
// rows, y_prev . Wy, the gates and r, z, n, ghn of each (row, unit) to
// gates.  Ends with a __syncthreads().
template <typename W>
__device__ void gates_all(const Args& a, const Ptrs<W>& P, int j0, int nu) {
  if (nu == 0) return;  // the whole block: it owns no units
  const int B = a.B, T = a.T, H = a.H, OUT = a.out, U = a.U, Hs = a.Hs, Rs = a.Rs;
  const int M = B * T, ts = tile_stride(sizeof(W)), nK = (Hs + kKC - 1) / kKC;
  const int qg = threadIdx.x / kRG, rg = threadIdx.x % kRG;  // qg is uniform in a warp
  const W* gx = static_cast<const W*>(a.gx);
  const W* yprev = static_cast<const W*>(a.yprev);
  const int tiles = (M + kMT - 1) / kMT;
  for (int ub = 0; ub < U; ub += 2 * kGU) {
    int wrow[kGU];  // offset of the unit's r row in shared memory (z, n follow by U rows)
#pragma unroll
    for (int uu = 0; uu < kGU; ++uu) wrow[uu] = min(ub + qg * kGU + uu, U - 1) * Rs;
    for (int ti = 0; ti < tiles; ++ti) {
      const int m0 = (ti + blockIdx.x) % tiles * kMT;
      float acc[kGR][kGU][3] = {};
      tile_copy<W>(a, P, m0, 0, 0);
      cp_async_commit();
      for (int kc = 0; kc < nK; ++kc) {
        if (kc + 1 < nK) {
          tile_copy<W>(a, P, m0, kc + 1, (kc + 1) & 1);
          cp_async_commit();
          cp_async_wait_group<1>();
        } else {
          cp_async_wait_group<0>();
        }
        __syncthreads();
        const W* tb = P.tile + ((size_t)(kc & 1) * kMT + rg) * ts;
        const W* wb = P.rows + kc * kKC;
        const int kw = min(kKC, Hs - kc * kKC);
#pragma unroll 2
        for (int x = 0; x < kw; x += 4) {
          float4 hv[kGR];
#pragma unroll
          for (int j = 0; j < kGR; ++j) hv[j] = load4(tb + (size_t)kRG * j * ts + x);
#pragma unroll
          for (int uu = 0; uu < kGU; ++uu) {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              const float4 w = load4(wb + wrow[uu] + (size_t)g * U * Rs + x);
#pragma unroll
              for (int j = 0; j < kGR; ++j) acc[j][uu][g] = dot4(w, hv[j], acc[j][uu][g]);
            }
          }
        }
        __syncthreads();  // the buffer is refilled by the copy after the next
      }
      // per block of kRG rows (a thread's row j): y_prev . Wy (the r and z rows
      // into the same sums as h_prev's, n apart) by the same threads; the sums
      // through shared memory to threads that run over units, which load the
      // streamed gates_x, form the gates and store the four values of each
      // (row, unit) to gates, both coalesced
#pragma unroll
      for (int j = 0; j < kGR; ++j) {  // unrolled: acc stays in registers
        const int r0 = m0 + kRG * j, nrows = min(kRG, M - r0);
        if (nrows <= 0) break;  // the same in every thread
        const W* y = yprev + (size_t)r0 * OUT;
        {  // y_prev of rows [r0, r0 + nrows): one span, 4 bytes at a time
          const int n = nrows * OUT, pieces = n * (int)sizeof(W) / 4;
          for (int c = threadIdx.x; c < pieces; c += kThreads)
            cp_async4(reinterpret_cast<char*>(P.tile) + 4 * c, reinterpret_cast<const char*>(y) + 4 * c);
          if (threadIdx.x == 0 && pieces * 4 < n * (int)sizeof(W)) P.tile[n - 1] = y[n - 1];
        }
        cp_async_wait_all();
        __syncthreads();
        float* sums = reinterpret_cast<float*>(P.tile) + wfloats((size_t)kRG * OUT, sizeof(W));
        if (rg < nrows) {  // sums[row][uu8][4]: r, z, hn, yn of 8 unit slots
          const W* yrow = P.tile + (size_t)rg * OUT;
          float yz[kGU][3] = {};
          for (int o = 0; o < OUT; ++o) {
            const float v = to_f(yrow[o]);
#pragma unroll
            for (int uu = 0; uu < kGU; ++uu) {
              const W* wy = P.wy + (size_t)wrow[uu] / Rs * OUT + o;
              yz[uu][0] = fmaf(to_f(wy[0]), v, yz[uu][0]);
              yz[uu][1] = fmaf(to_f(wy[(size_t)U * OUT]), v, yz[uu][1]);
              yz[uu][2] = fmaf(to_f(wy[(size_t)2 * U * OUT]), v, yz[uu][2]);
            }
          }
#pragma unroll
          for (int uu = 0; uu < kGU; ++uu)
            *reinterpret_cast<float4*>(sums + ((size_t)rg * 2 * kGU + qg * kGU + uu) * 4) =
                make_float4(acc[j][uu][0] + yz[uu][0], acc[j][uu][1] + yz[uu][1], acc[j][uu][2],
                            yz[uu][2]);
        }
        __syncthreads();
        constexpr int kPer = kRG * 2 * kGU / kThreads;  // (row, unit) pairs a thread finishes
        float sg[kPer][3];  // streamed gates_x, all loads in flight
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int pr = threadIdx.x + e * kThreads, r = pr / (2 * kGU);
          const int uc = min(ub + pr % (2 * kGU), nu - 1), m = r0 + min(r, nrows - 1);
          const size_t gi = (size_t)m * 3 * H + j0 + uc;
          sg[e][0] = to_f(gx[gi]);
          sg[e][1] = to_f(gx[gi + H]);
          sg[e][2] = to_f(gx[gi + 2 * H]);
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int pr = threadIdx.x + e * kThreads, r = pr / (2 * kGU), u = ub + pr % (2 * kGU);
          if (r >= nrows || u >= nu) continue;
          const float4 sum = *reinterpret_cast<const float4*>(sums + (size_t)pr * 4);
          const float rg_ = sigmoid_f(sg[e][0] + (sum.x + P.bhh[u]));
          const float zg = sigmoid_f(sg[e][1] + (sum.y + P.bhh[U + u]));
          const float ghn = sum.z + P.bhh[2 * U + u];
          float* o = a.gates + (size_t)(r0 + r) * kGates * H + j0 + u;  // gate q at + q * H
          __stcg(o, rg_);
          __stcg(o + H, zg);
          __stcg(o + 2 * H, tanhf((sg[e][2] + sum.w) + rg_ * ghn));
          __stcg(o + 3 * H, ghn);
        }
        __syncthreads();  // the tile is refilled by the next block of rows or tile
      }
    }
  }
}

// Step t's gates of the block's nu units (B x 4 runs of nu floats of gates,
// 16-byte pieces where they are whole, else 4 bytes at a time) and d_trj[t]
// into shared memory
template <typename W>
__device__ __forceinline__ void step_copy(const Args& a, const Ptrs<W>& P, int t, int j0, int nu) {
  const int Us = a.Us, H = a.H;
  const float* g = a.gates + (size_t)t * kGates * H + j0;  // row b's gate q at + (b T 4 + q) H
  const size_t row = (size_t)a.T * kGates * H;
  if (a.vec) {
    const int per = (nu + 3) / 4, n = kGates * a.B * per;
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const int bq = c / per, x = c - bq * per;  // bq = b * 4 + q
      cp_async16(P.gate + (size_t)bq * Us + 4 * x,
                 g + (bq >> 2) * row + (size_t)(bq & 3) * H + 4 * x);
    }
  } else {
    const int n = kGates * a.B * nu;
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const int bq = c / nu, u = c - bq * nu;
      cp_async4(P.gate + (size_t)bq * Us + u, g + (bq >> 2) * row + (size_t)(bq & 3) * H + u);
    }
  }
  for (int idx = threadIdx.x; idx < a.B * a.out; idx += kThreads) {
    const int b = idx / a.out, o = idx % a.out;
    cp_async4(P.dtr + idx, a.dtrj + ((size_t)b * a.T + t) * a.out + o);
  }
}

// Block kk's partial of dh over its 3U rows, for R batch rows from b0 and the
// four columns [i, i+4): sum_r dgh[b][r] Whh[r][i..i+3], written for the
// blocks that own those columns (dst: this block's partials of block 0).
template <typename W, int R>
__device__ __forceinline__ void dh_partial(const Args& a, const Ptrs<W>& P, float* dst, int i,
                                           int b0) {
  const int R3 = 3 * a.U, Rs = a.Rs, Bp = a.Bp;
  float4 acc[R];
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = 0; r < R3; ++r) {  // rows of units past nu are zero in dgh
    const float4 w = load4(P.rows + (size_t)r * Rs + i);
    const float* d = P.dgh + (size_t)r * Bp + b0;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float v = d[c];
      acc[c] = make_float4(fmaf(v, w.x, acc[c].x), fmaf(v, w.y, acc[c].y), fmaf(v, w.z, acc[c].z),
                           fmaf(v, w.w, acc[c].w));
    }
  }
  const int U = a.U, Us = a.Us;
  const size_t dest_stride = (size_t)gridDim.x * a.B * Us;
  if (U % 4 == 0) {  // the four columns belong to one block
    float* o = dst + (i / U) * dest_stride + i % U;
#pragma unroll
    for (int c = 0; c < R; ++c) __stcg(reinterpret_cast<float4*>(o + (size_t)(b0 + c) * Us), acc[c]);
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float v[4] = {acc[c].x, acc[c].y, acc[c].z, acc[c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i + e;
        if (col < a.H) __stcg(dst + (col / U) * dest_stride + (size_t)(b0 + c) * Us + col % U, v[e]);
      }
    }
  }
}

// This block's partial of dh (all H columns) over its own 3U rows, into
// the step's buffers p
template <typename W>
__device__ __forceinline__ void dh_partials(const Args& a, const Ptrs<W>& P, int p) {
  const int G = gridDim.x, k = blockIdx.x, B = a.B;
  float* dst = a.pbuf + ((size_t)p * G * G + k) * B * a.Us;
  for (int i = 4 * threadIdx.x; i < a.H; i += 4 * kThreads) {
    for (int b0 = 0; b0 < B; b0 += kPB) {
      switch (min(kPB, B - b0)) {
        case 1: dh_partial<W, 1>(a, P, dst, i, b0); break;
        case 2: dh_partial<W, 2>(a, P, dst, i, b0); break;
        case 3: dh_partial<W, 3>(a, P, dst, i, b0); break;
        case 4: dh_partial<W, 4>(a, P, dst, i, b0); break;
        case 5: dh_partial<W, 5>(a, P, dst, i, b0); break;
        case 6: dh_partial<W, 6>(a, P, dst, i, b0); break;
        case 7: dh_partial<W, 7>(a, P, dst, i, b0); break;
        case 8: dh_partial<W, 8>(a, P, dst, i, b0); break;
        case 9: dh_partial<W, 9>(a, P, dst, i, b0); break;
        default: dh_partial<W, kPB>(a, P, dst, i, b0); break;
      }
    }
  }
}

// ... and its partial of dy (all B*out values)
template <typename W>
__device__ __forceinline__ void dy_partial(const Args& a, const Ptrs<W>& P, int p) {
  const int G = gridDim.x, k = blockIdx.x, B = a.B, OUT = a.out, R3 = 3 * a.U;
  float* dpart = a.dbuf + ((size_t)p * G + k) * a.DS;
  for (int idx = threadIdx.x; idx < B * OUT; idx += kThreads) {
    const int b = idx / OUT, o = idx % OUT;
    float acc = 0.f;
    for (int r = 0; r < R3; ++r)
      acc = fmaf(P.dgx[(size_t)r * a.Bp + b], to_f(P.wy[(size_t)r * OUT + o]), acc);
    __stcg(dpart + idx, acc);
  }
}

// The dh partials of the block's units, (G, B, Us) from src, copied in passes
// of stage_kk and summed in a fixed order (thread (q, bu) sums partials q,
// q + nq, ...; then the nq sums in order); emit(b, u, sum) for each own
// (row, unit).  With `issued`, the first pass's copy is already in flight.
// Its waits also complete any other copy in flight.
template <typename W, typename Emit>
__device__ __forceinline__ void sum_dh(const Args& a, const Ptrs<W>& P, const float* src, int nu,
                                       bool issued, Emit emit) {
  const int G = gridDim.x, B = a.B, U = a.U, Us = a.Us, BU = B * U, per = B * Us;
  const int nq = max(1, kThreads / BU);
  for (int k0 = 0; k0 < G; k0 += a.stage_kk) {
    const int nk = min(a.stage_kk, G - k0);
    if (k0 > 0 || !issued)
      for (int c = threadIdx.x; c < nk * per / 4; c += kThreads)
        cp_async16(P.stage + 4 * c, src + (size_t)k0 * per + 4 * c);
    cp_async_wait_all();
    __syncthreads();
    for (int x = threadIdx.x; x < nq * BU; x += kThreads) {
      const int q = x / BU, bu = x % BU, b = bu / U, u = bu % U;
      float acc = k0 == 0 ? 0.f : P.red[x];
      if (u < nu)
        for (int kk = q; kk < nk; kk += nq) acc += P.stage[(size_t)kk * per + b * Us + u];
      P.red[x] = acc;
    }
    __syncthreads();
  }
  for (int bu = threadIdx.x; bu < BU; bu += kThreads) {
    const int b = bu / U, u = bu % U;
    if (u >= nu) continue;
    float s = 0.f;
    for (int q = 0; q < nq; ++q) s += P.red[q * BU + bu];
    emit(b, u, s);
  }
}

// This block's slice of dy, [k*S, k*S+S) within the first n values: each the
// G partials of src (stride DS) summed in a fixed order, lanes over the
// partials, then a butterfly; emit(idx, sum) by lane 0.
template <typename Emit>
__device__ __forceinline__ void sum_dy_slice(const Args& a, const float* src, int n, Emit emit) {
  const int G = gridDim.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int sv = warp; sv < a.S; sv += kWarps) {
    const int idx = blockIdx.x * a.S + sv;
    if (idx >= n) break;
    float acc = 0.f;
#pragma unroll 4
    for (int kk = lane; kk < G; kk += 32) acc += __ldcg(src + (size_t)kk * a.DS + idx);
    acc = warp_sum(acc);
    if (lane == 0) emit(idx, acc);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 1) gru_ar_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, OUT = a.out, U = a.U, Rs = a.Rs, Us = a.Us, Bp = a.Bp;
  const int G = gridDim.x, k = blockIdx.x, j0 = k * U, BO = B * OUT, YW = a.YW;
  const int nu = max(0, min(U, H - j0));  // units this block owns (last block may be ragged)
  const Smem L = smem_layout(B, H, OUT, U, a.stage_kk, sizeof(W));

  Ptrs<W> P;
  P.stage = smem + L.stage;
  P.tile = reinterpret_cast<W*>(smem + L.tile);
  P.dtr = smem + L.dtr;
  P.dyt = smem + L.dyt;
  P.gate = smem + L.gate;
  P.dh = smem + L.dh;
  P.dhz = smem + L.dhz;
  P.dgh = smem + L.dgh;
  P.dgx = smem + L.dgx;
  P.red = smem + L.red;
  P.bhh = smem + L.bhh;
  P.rows = reinterpret_cast<W*>(smem + L.rows);  // row g*U + u: gate g of unit j0+u
  P.wy = reinterpret_cast<W*>(smem + L.wy);
  P.wout = reinterpret_cast<W*>(smem + L.wout);

  const W* wy = static_cast<const W*>(a.wy);
  const W* whh = static_cast<const W*>(a.whh);
  const W* wout = static_cast<const W*>(a.wout);
  const W* hprev = static_cast<const W*>(a.hprev);
  const W* mask = static_cast<const W*>(a.mask);
  W* dgx = static_cast<W*>(a.dgx);
  W* dgh = static_cast<W*>(a.dgh);
  unsigned* count1 = reinterpret_cast<unsigned*>(a.ybuf + 2 * (size_t)YW);  // partials stored
  unsigned* count2 = count1 + 1;                                            // dy slices stored (a hint)

  // ---- weights into shared memory, once per call ----
  for (int idx = threadIdx.x; idx < 3 * U * Rs; idx += kThreads) {
    const int r = idx / Rs, i = idx % Rs, g = r / U, u = r % U;
    P.rows[idx] = (u < nu && i < H) ? whh[(size_t)(g * H + j0 + u) * H + i] : from_f<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < 3 * U * OUT; idx += kThreads) {
    const int r = idx / OUT, o = idx % OUT, g = r / U, u = r % U;
    P.wy[idx] = u < nu ? wy[(size_t)(g * H + j0 + u) * OUT + o] : from_f<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < U * OUT; idx += kThreads) {
    const int u = idx / OUT, o = idx % OUT;
    P.wout[idx] = u < nu ? wout[(size_t)o * H + j0 + u] : from_f<W>(0.f);
  }
  for (int r = threadIdx.x; r < 3 * U; r += kThreads) {
    const int g = r / U, u = r % U;
    P.bhh[r] = u < nu ? a.bhh[g * H + j0 + u] : 0.f;
  }
  for (int idx = threadIdx.x; idx < 3 * U * Bp; idx += kThreads) P.dgh[idx] = P.dgx[idx] = 0.f;
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads)
    P.dh[(idx / nu) * U + idx % nu] = a.dhT[(size_t)(idx / nu) * H + j0 + idx % nu];
  __syncthreads();

#ifdef GRU_AR_BWD_PROFILE
  long long prof_acc[kPhases] = {}, prof_t = clock64();
#endif
  // ---- the gates of every step where none are given, then step T-1's
  // share of them; h_prev and mask of this thread's (row, unit) (the first
  // of the algebra's passes) one step ahead, in registers at W (converted
  // where they are used, so that no thread waits for the load at its
  // issue) ----
  if (a.recompute) {
    gates_all<W>(a, P, j0, nu);
    __threadfence_block();  // this block's gate stores before its copies of them
    __syncthreads();
  }
  step_copy<W>(a, P, T - 1, j0, nu);
  const int ab = threadIdx.x / U, au = threadIdx.x % U;
  const bool ahead = threadIdx.x < B * U && au < nu;
  const size_t at0 = ((size_t)ab * T + T - 1) * H + j0 + au;
  W hp_next = ahead ? hprev[at0] : from_f<W>(0.f), m_next = ahead ? mask[at0] : from_f<W>(0.f);
  cp_async_wait_all();
  __syncthreads();
  PROF_MARK(7);

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s, p = s & 1;

    // ---- the carries: dh (own units) and dy_tot = d_trj[t] + dy ----
    if (s == 0) {
      for (int idx = threadIdx.x; idx < BO; idx += kThreads) P.dyt[idx] = P.dtr[idx] + a.dyT[idx];
      __syncthreads();
    } else {
      const int q = p ^ 1;  // step s-1's buffers
      const unsigned tag = (unsigned)s;
      if (threadIdx.x == 0) wait_acquire(count1, (unsigned)G * s);
      __syncthreads();
      PROF_MARK(0);
      // hop 1 has landed: this block's slice of dy is summed and stored with its
      // tag (hop 2), then the dh partials start copying
      unsigned long long* ydst = a.ybuf + (size_t)q * YW;
      sum_dy_slice(a, a.dbuf + (size_t)q * G * a.DS, YW,
                   [&](int idx, float v) { store_tagged(ydst + idx, v, tag); });
      if (threadIdx.x == 0) add_count(count2);  // a hint: the tags decide
      PROF_MARK(1);
      const float* psrc = a.pbuf + ((size_t)q * G + k) * G * B * Us;
      for (int c = threadIdx.x; c < a.stage_kk * B * Us / 4; c += kThreads)
        cp_async16(P.stage + 4 * c, psrc + 4 * c);
      sum_dh<W>(a, P, psrc, nu, true,
                [&](int b, int u, float v) { P.dh[b * U + u] = P.dhz[b * U + u] + v; });
      PROF_MARK(2);
      if (threadIdx.x == 0) wait_count(count2, (unsigned)G * s);
      __syncthreads();
      for (int pi = threadIdx.x; pi < YW / 2; pi += kThreads) {
        const long long start = clock64();
        ulonglong2 w;
        for (;;) {
          w = load_tagged2(ydst + 2 * pi);
          if (tag_of(w.x) == tag && tag_of(w.y) == tag) break;
          spin_guard(start);
        }
        P.dyt[2 * pi] = P.dtr[2 * pi] + value_of(w.x);
        P.dyt[2 * pi + 1] = P.dtr[2 * pi + 1] + value_of(w.y);  // past B*out: unused
      }
      __syncthreads();
      PROF_MARK(3);
    }
    if (k == 0)
      for (int idx = threadIdx.x; idx < BO; idx += kThreads) {
        const int b = idx / OUT, o = idx % OUT;
        a.dytot[((size_t)b * T + t) * OUT + o] = P.dyt[idx];
      }

    // ---- the cotangent algebra, a thread per own (row, unit) ----
    for (int bu = threadIdx.x; bu < B * U; bu += kThreads) {
      const bool first = bu == (int)threadIdx.x;
      const int b = first ? ab : bu / U, u = first ? au : bu % U;
      if (u >= nu) continue;
      const size_t at = ((size_t)b * T + t) * H + j0 + u;
      const float hp = to_f(first ? hp_next : hprev[at]), m = to_f(first ? m_next : mask[at]);
      const float* dt = P.dyt + b * OUT;
      const W* wo = P.wout + u * OUT;
      float s0 = 0.f, s1 = 0.f;  // dy_tot . Wout[:, j], dy_tot rounded to W
      int o = 0;
      for (; o + 2 <= OUT; o += 2) {
        s0 = fmaf(to_f(wo[o]), round_w<W>(dt[o]), s0);
        s1 = fmaf(to_f(wo[o + 1]), round_w<W>(dt[o + 1]), s1);
      }
      if (o < OUT) s0 = fmaf(to_f(wo[o]), round_w<W>(dt[o]), s0);
      const float* g = P.gate + (size_t)b * kGates * Us + u;
      const float rg = g[0], zg = g[Us], ng = g[2 * Us], ghn = g[3 * Us];
      const float dh_tot = P.dh[bu] + (s0 + s1) * m;
      const float dz = dh_tot * (hp - ng);
      const float dn = dh_tot * (1.f - zg);
      const float dgn = dn * (1.f - ng * ng);
      const float dr = dgn * ghn;
      const float dghn = dgn * rg;
      const float dgr = dr * rg * (1.f - rg);
      const float dgz = dz * zg * (1.f - zg);
      const W qr = from_f<W>(dgr), qz = from_f<W>(dgz), qn = from_f<W>(dgn), qhn = from_f<W>(dghn);
      const size_t bt = ((size_t)b * T + t) * 3 * H + j0 + u;
      dgx[bt] = qr;
      dgx[bt + H] = qz;
      dgx[bt + 2 * H] = qn;
      dgh[bt] = qr;
      dgh[bt + H] = qz;
      dgh[bt + 2 * H] = qhn;
      P.dgh[(size_t)u * Bp + b] = P.dgx[(size_t)u * Bp + b] = to_f(qr);
      P.dgh[(size_t)(U + u) * Bp + b] = P.dgx[(size_t)(U + u) * Bp + b] = to_f(qz);
      P.dgx[(size_t)(2 * U + u) * Bp + b] = to_f(qn);
      P.dgh[(size_t)(2 * U + u) * Bp + b] = to_f(qhn);
      P.dhz[bu] = dh_tot * zg;
    }
    __syncthreads();
    if (s + 1 < T) {  // land during the next step's exchange
      step_copy<W>(a, P, t - 1, j0, nu);
      if (ahead) {
        const size_t at = ((size_t)ab * T + t - 1) * H + j0 + au;
        hp_next = hprev[at];
        m_next = mask[at];
      }
    }
    PROF_MARK(4);

    // ---- the partials of dh and dy, then the block's arrival (hop 1) ----
    dh_partials<W>(a, P, p);
    PROF_MARK(5);
    dy_partial<W>(a, P, p);
    __syncthreads();
    if (threadIdx.x == 0) arrive_release(count1);
    PROF_MARK(6);
  }
#ifdef GRU_AR_BWD_PROFILE
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) g_prof[i] += prof_acc[i];
#endif

  // ---- dh_0 (each block its units) and dy_0 (each block its slice) ----
  const int last = (T - 1) & 1;
  if (threadIdx.x == 0) wait_acquire(count1, (unsigned)G * T);
  __syncthreads();
  sum_dh<W>(a, P, a.pbuf + ((size_t)last * G + k) * G * B * Us, nu, false,
            [&](int b, int u, float v) { a.dh0[(size_t)b * H + j0 + u] = P.dhz[b * U + u] + v; });
  sum_dy_slice(a, a.dbuf + (size_t)last * G * a.DS, BO, [&](int idx, float v) { a.dy0[idx] = v; });
}

// dy values each block sums: B*out over the G blocks, rounded up to 4
inline int dy_slice(int B, int out, int G) { return (int)up4(((size_t)B * out + G - 1) / G); }

template <typename W>
int plan(int B, int H, int out, int* grid, int* units, int* stage_kk, int* smem) {
  if (B < 1 || H < 1 || out < 1) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e != cudaSuccess) return e;
  // fewest units per block (most blocks) whose grid is co-resident; the dh
  // stage takes what shared memory is left, up to all G partials
  for (int U = (H + sms - 1) / sms; U <= H && U <= kThreads; ++U) {
    const int G = (H + U - 1) / U;
    int kk = G;
    while (kk >= 1 && smem_layout(B, H, out, U, kk, sizeof(W)).total_bytes > (size_t)optin) --kk;
    if (kk < 1) continue;
    const size_t s = smem_layout(B, H, out, U, kk, sizeof(W)).total_bytes;
    bool fits = false;
    e = co_resident(gru_ar_bwd_kernel<W>, s, sms, G, &fits);
    if (e != cudaSuccess) return e;
    if (fits) {
      *grid = G;
      *units = U;
      *stage_kk = kk;
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
           void* dy0, void* gates, void* pbuf, void* dbuf, void* ybuf, int B, int T, int H, int out,
           int grid, int units, int stage_kk, int smem, int recompute, void* stream) {
  if (B < 1 || T < 1 || H < 1 || out < 1 || units < 1 || units > kThreads || stage_kk < 1 ||
      stage_kk > grid || (long long)grid * units < H || (long long)(grid - 1) * units >= H ||
      gates == nullptr)
    return cudaErrorInvalidValue;
  const int vec =
      units % 4 == 0 && H % 4 == 0 && reinterpret_cast<unsigned long long>(gates) % 16 == 0;
  const int S = dy_slice(B, out, grid);
  Args a{static_cast<const float*>(dtrj), gx, yprev, hprev, mask, wout, whh, wy,
         static_cast<const float*>(bhh), static_cast<const float*>(dhT),
         static_cast<const float*>(dyT), dgx, dgh, static_cast<float*>(dytot),
         static_cast<float*>(dh0), static_cast<float*>(dy0), static_cast<float*>(gates),
         static_cast<float*>(pbuf), static_cast<float*>(dbuf),
         static_cast<unsigned long long*>(ybuf), B, T, H, out, units, (int)up4(H),
         row_stride(H, sizeof(W)), (int)up4(units), (int)up4(B), S, grid * S,
         (B * out + 1) / 2 * 2, stage_kk, recompute != 0, vec};
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

// blocks, units per block, dh partials copied per pass and dynamic shared
// bytes for one call
int gru_ar_bwd_plan_f32(int B, int H, int out, int* grid, int* units, int* stage_kk, int* smem) {
  return plan<float>(B, H, out, grid, units, stage_kk, smem);
}
int gru_ar_bwd_plan_bf16(int B, int H, int out, int* grid, int* units, int* stage_kk, int* smem) {
  return plan<__nv_bfloat16>(B, H, out, grid, units, stage_kk, smem);
}

// gates: (B, T, 4, H) floats, r, z, n and ghn of every (row, step, unit):
// the training forward's (recompute 0), or scratch, not initialised, that the
// kernel fills from gates_x, y_prev and h_prev first (recompute 1); pbuf: (2,
// grid, grid, B, Us) and dbuf: (2, grid, grid * S) floats, none initialised;
// ybuf: 2 * YW + 1 8-byte words, zeroed (Us = units rounded up to a multiple
// of 4, S = ceil(B * out / grid) rounded up to a multiple of 4, YW = B * out
// rounded up to even)
int gru_ar_bwd_f32(const void* dtrj, const void* gx, const void* yprev, const void* hprev,
                   const void* mask, const void* wout, const void* whh, const void* wy,
                   const void* bhh, const void* dhT, const void* dyT, void* dgx, void* dgh,
                   void* dytot, void* dh0, void* dy0, void* gates, void* pbuf, void* dbuf,
                   void* ybuf, int B, int T, int H, int out, int grid, int units, int stage_kk,
                   int smem, int recompute, void* stream) {
  return launch<float>(dtrj, gx, yprev, hprev, mask, wout, whh, wy, bhh, dhT, dyT, dgx, dgh, dytot,
                       dh0, dy0, gates, pbuf, dbuf, ybuf, B, T, H, out, grid, units, stage_kk,
                       smem, recompute, stream);
}
int gru_ar_bwd_bf16(const void* dtrj, const void* gx, const void* yprev, const void* hprev,
                    const void* mask, const void* wout, const void* whh, const void* wy,
                    const void* bhh, const void* dhT, const void* dyT, void* dgx, void* dgh,
                    void* dytot, void* dh0, void* dy0, void* gates, void* pbuf, void* dbuf,
                    void* ybuf, int B, int T, int H, int out, int grid, int units, int stage_kk,
                    int smem, int recompute, void* stream) {
  return launch<__nv_bfloat16>(dtrj, gx, yprev, hprev, mask, wout, whh, wy, bhh, dhT, dyT, dgx,
                               dgh, dytot, dh0, dy0, gates, pbuf, dbuf, ybuf, B, T, H, out, grid,
                               units, stage_kk, smem, recompute, stream);
}

#ifdef GRU_AR_BWD_PROFILE
int gru_ar_bwd_profile_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[kPhases] = {};
  return cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
