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
// the time is T times the latency of one step: a chain of one exchange
// between SMs, a 128-long dot product, a 256-way argmax, a table-row add and
// the gate nonlinearity.  The design keeps that chain short:
//   * ONE launch runs the whole time loop; the weights are read from device
//     memory once.  Block k owns hidden units [k*U, k*U+U) (U = 8, 112 blocks
//     at H = 896); each warp holds its unit's three Whh rows in registers.
//   * The blocks form thread-block clusters of cs (8 where the card can keep
//     them all resident, else 4, 2, 1; the grid is padded to a multiple of
//     cs with blocks that own no units).  Inside a cluster nothing waits at
//     a cluster barrier: a block pushes data straight into the shared memory
//     of the block that needs it (st.async), and the receiver's mbarrier
//     counts the bytes.  (A cluster barrier or a fence with release/acquire
//     semantics compiles to MEMBAR.GPU plus an L1 invalidate, ~1,000 cycles.)
//   * Per step a block pushes its partial of f = h_t . W1^T over its units
//     to the ranks that own those f values; rank r sums its share of the cs
//     partials in rank order and writes it to L2.  So G/cs cluster partials
//     cross SMs (7 KB per batch row at cs = 8, not the 57 KB of 112 block
//     partials).
//   * Across the grid there is no barrier and no fence: every float of h_t
//     and of the cluster partials travels in one 8-byte word with the step
//     that wrote it (st.relaxed.gpu), so a reader checks the data itself.
//     To keep 28k threads from polling L2 at once, one thread per block
//     first waits on a count of the blocks that stored the step (a relaxed
//     red per block: only a hint, the tags decide); then every thread loads
//     its words (ld.relaxed.gpu, up to 8 16-byte loads in flight) and loads
//     again those whose tag is old.  Double buffers by step parity suffice:
//     a block can write step t+2's words only after every block has read
//     step t's.  While thread 0 waits, the block draws the Philox noise of
//     the coming sample (it depends on (seed, t, b, k) only); the
//     conditioning gates of the next step are loaded into registers one
//     step ahead.
//   * The logits are split across the cluster: rank r scores classes
//     [r*Kc, r*Kc + Kc) (its slice of W2, row-major, in shared memory), eight
//     lanes to a class, float4 reads and a shuffle reduce, and pushes the
//     best (score, class) of each row, as one 64-bit key, to every rank.
//     Every block sums the NC cluster partials in the same fixed order, and
//     every cluster holds the same W2 slices and draws the same noise, so
//     every block reaches the same sample bit for bit, with no atomics on
//     the value path; the largest key (ties to the lowest class, NaN above
//     every number) is one element whatever the order of merging.
//   * While the candidates cross the cluster, each warp runs its unit's
//     Whh . h_t dot products (they do not depend on the sample), so after
//     the merge only the table row (the block's (K, 3U) slice of emb_tab, in
//     shared memory), the gate nonlinearity, h and the fc1 partial remain.
//   * The step loop does no integer division: what depends on the thread
//     alone is computed once.  (Measured with the profile below: a phase of
//     a few hundred instructions takes 300-1,000 cycles, so every
//     instruction on the chain counts.)
//   * Offsets into cond_gates and out are size_t: B * T * 3H passes 2^31
//     from B = 9 at T = 99,225.
// No tensor cores and no TF32: B is 1-8 (B * FC <= 1,024) and the weights
// stay float32.
// Every block waits on data of every other, so all must be resident: the
// launch is cooperative (it fails rather than run a grid that does not fit)
// with a cluster dimension, and the plan checks
// cudaOccupancyMaxActiveClusters.
//
// Built with -DWAVERNN_PROFILE, thread 0 of block 0 sums the SM cycles each
// phase of a step takes (wavernn_profile_read; ops/wavernn_phases.py names
// and prints them; each PROF_MARK(i) closes phase i); in the dual, thread 0
// of the first block of each half, per phase of the step (DUAL_MARK,
// wavernn_profile_read_dual, wavernn_phases --dual).
//
// The second instantiation, wavernn_kernel_dual: the published WaveRNN's
// dual softmax over 16-bit audio (Kalchbrenner et al., arXiv:1802.08435,
// eq. 2; models/wavernn.py; no TPU kernel has it).  It shares K4's device
// functions where a stage has K4's shape (the weight staging, the GRU cell,
// the first-layer partials and their sum in the cluster, the fixed-order
// sum, the argmax key; Philox, exchange.cuh), has its own where its
// schedule needs another (the split Whh products, the value-split logits,
// the noise of one class), and the same cooperative launch in clusters; the poll of tagged
// words on the chain is written in each kernel (in a device function it
// slows K4 by 3.5%).  Per step t, for the batch rows b (h = 0, c = 128, f =
// 0 before step 0; Hh = H/2; x~ = x / 127.5 - 1, a true division):
//   gh  = h_{t-1} . Whh^T + b_hh                     (both halves, off the chain)
//   phase 0, the coarse units [0, Hh): gx = ((cond_gates + c~_{t-1} w0)
//       + f~_{t-1} w1) + c~_{t-1} w2 (each product and sum rounded; w the
//       masked input weights, w2 = 0 on these rows), the GRU cell as above,
//       y_c; scores = (relu(y_c O1^T + b1) O2^T + b2) / temp + g0; c_t = argmax
//   phase 1, the fine units [Hh, H): the same with c~_t in the last input,
//       y_f; O3, O4, b3, b4, noise g1; f_t = argmax; out[b, t] = c_t * 256 + f_t.
// The coarse noise is K4's: counter (t, b, k/4, 0); the fine (t, b, k/4, 1).
// What bounds it: as K4, the chain of dependent steps, now two a sample,
// each with H/2-wide first layers (O1, O3 are H/2 x H/2, not fc x H).
// Measured on its first design (wavernn_phases --dual), a phase waited not
// for data but for moving it: every block read the whole first layer of the
// head from L2 (~3 TB/s for the same words) and every class group all of it
// from shared memory.  The design:
//   * Each half has its own blocks (U = 8 units, Hh / U of them, padded to
//     whole clusters), so a phase's first-layer partials come from the
//     clusters of its half; every cluster computes both heads' logits and so
//     reaches c_t and f_t itself.
//   * The first layer is split by value across the cluster: rank r owns
//     Cs = ceil(Hh / cs) (up to 4) values of each row.  The blocks of the
//     half push their partials of those values to rank r, which sums the
//     cluster's cs partials in rank order and stores them; in every cluster
//     rank r then polls only its values from the NCh clusters (1/cs of the
//     words), sums them in a fixed order, and forms their partial logits of
//     every class (a thread to a class; O2 / O4 columns of its values in
//     shared memory, f read by all lanes at once).  Each class's cs partial
//     logits go to the rank that owns the class (st.async, its mbarrier
//     counting the bytes), which sums them in rank order, adds the bias and
//     the noise, and pushes its best (score, class) to every rank as K4.
//   * A phase's chain carries only what decides its sample.  gh for every
//     unit is computed once a step in two parts, each lane's sums carried
//     between them in shared memory (gate_dots' order, so its gh bit for
//     bit; rows past kBatchChunk whole in the second part): at the end of
//     each phase, over the columns of that phase's half of h_t, while the
//     phase's candidates cross the cluster.  Each half's h_t rides in its
//     phase's poll with the values (the same round trip through L2).  The
//     lanes that score a row draw its noise before the values can arrive.
//     No count of the stores precedes the poll (it cost a round trip
//     through L2 a phase): the tags decide, and since a rank's scores need
//     every rank's partial logits, no block passes a phase before its
//     cluster has merged the last one's samples, which orders the reuse of
//     every buffer in the cluster.
//   * Exchange regions by head and step parity; a word carries its step.  A
//     block writes a region's step t+2 only after its cluster has consumed
//     words that every reader of step t wrote after reading step t (through
//     the samples the cluster merged).

#include <algorithm>

#include <cooperative_groups.h>

#include "exchange.cuh"
#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru;

constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kU = kWarps;      // hidden units per block: one warp per unit
constexpr int kLanesPerClass = 8;
constexpr int kClassGroups = kThreads / kLanesPerClass;
constexpr int kPoll = 8;  // 16-byte words a thread has in flight when it polls

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
  // (2, XW) + 1 tagged words: per step parity the NC cluster partials of f
  // (BFs each), then h_t (B rows of Hs); then the step count
  unsigned long long* xbuf;
  unsigned seed;
  float temp;
  int B, T, H, K, FC, cs;
  int Hs, FCs, Kc;     // padded lengths (multiples of 4 floats = 16 bytes)
  int stage_rows;      // f values (multiple of 4) summed per pass through smem
};

#ifdef WAVERNN_PROFILE
constexpr int kPhases = 12;
__device__ unsigned long long g_prof[kPhases];
#define PROF_MARK(i)                                            \
  do {                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
      const long long now = clock64();                          \
      prof_s[i] += now - prof_t;                                \
      prof_t = now;                                             \
    }                                                           \
  } while (0)
// the dual's: marks of one phase, summed by thread 0 of the first block of
// each half; [half][phase][mark], then [half][phase] the poll passes that
// found a stale word, summed over the block's threads
constexpr int kDualMarks = 11;
__device__ unsigned long long g_prof_dual[2 * 2 * kDualMarks + 4];
#define DUAL_MARK(i)                                            \
  do {                                                          \
    if (kl == 0 && threadIdx.x == 0) {                          \
      const long long now = clock64();                          \
      prof_s[p * kDualMarks + (i)] += now - prof_t;             \
      prof_t = now;                                             \
    }                                                           \
  } while (0)
#else
#define PROF_MARK(i) \
  do {               \
  } while (0)
#define DUAL_MARK(i) \
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

// Gumbel noise from 23 random bits, as the TPU kernel forms it
__device__ __forceinline__ float gumbel(unsigned bits) {
  const float u = (float)(bits & 0x7fffffu) * (1.0f / 8388608.0f);
  return -logf(-logf(u + 1e-9f) + 1e-9f);
}

// The argmax as jnp.argmax and torch.argmax take it (the larger score, on a
// tie the lower class, every NaN above every number, -0 equal to +0) is the
// largest of these keys: the score's bits made monotone in its value, over
// the class inverted.  Key 0 lies below every (score, class).
__device__ __forceinline__ unsigned long long arg_key(float v, int k) {
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  const unsigned m = isnan(v) ? 0xffffffffu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)m << 32) | (0xffffffffu - (unsigned)k);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
}
// the best of the cs candidates of a row (ranks past cs read rank cs-1
// again, which changes no maximum, so that all loads are in flight at once)
__device__ __forceinline__ unsigned long long best_candidate(const unsigned long long* cand, int cs) {
  unsigned long long c[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) c[r] = cand[min(r, cs - 1)];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) c[0] = max(c[0], c[r]);
  return c[0];
}

// gh of the warp's unit u for R batch rows from b0 (rows past B repeat row
// B-1 and are dropped: branch-free, so the loads are batched): its three
// Whh rows (registers) against h (shared memory), + b_hh, into gh_s
template <int R>
__device__ __forceinline__ void gate_dots(const float4 (&wreg)[3][kRegIters], const float* h_s,
                                          const float* bhh_s, float* gh_s, int B, int H, int Hs,
                                          int b0, int u, int lane) {
  int row[R];
#pragma unroll
  for (int c = 0; c < R; ++c) row[c] = min(b0 + c, B - 1);
  float sr[R] = {}, sz[R] = {}, sn[R] = {};
#pragma unroll
  for (int it = 0; it < kRegIters; ++it) {
    const int i = 128 * it + 4 * lane;
    if (i < H) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(h_s + (size_t)row[c] * Hs + i);
        sr[c] = dot4(wreg[0][it], v, sr[c]);
        sz[c] = dot4(wreg[1][it], v, sz[c]);
        sn[c] = dot4(wreg[2][it], v, sn[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const float s0 = warp_sum(sr[c]), s1 = warp_sum(sz[c]), s2 = warp_sum(sn[c]);
    if (lane == 0 && b0 + c < B) {
      float* gh = gh_s + (b0 + c) * 3 * kU;
      gh[u] = s0 + bhh_s[u];
      gh[kU + u] = s1 + bhh_s[kU + u];
      gh[2 * kU + u] = s2 + bhh_s[2 * kU + u];
    }
  }
}

// f values owned (summed over the cluster) by each rank: a multiple of 4
__host__ __device__ inline int rank_share(int BFs, int cs) { return (int)up4((BFs + cs - 1) / cs); }

// ---- the stages of K4's step; the dual's phases run most of them too ----

// the three Whh rows g*H + j of unit j into registers, float4 it at 128*it + 4*lane
__device__ __forceinline__ void load_whh(float4 (&wreg)[3][kRegIters], const float* whh, int H,
                                         int j, int lane) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int it = 0; it < kRegIters; ++it) {
      const int i = 128 * it + 4 * lane;
      const float* row = whh + (size_t)(g * H + j) * H;
      wreg[g][it] = make_float4(i < H ? row[i] : 0.f, i + 1 < H ? row[i + 1] : 0.f,
                                i + 2 < H ? row[i + 2] : 0.f, i + 3 < H ? row[i + 3] : 0.f);
    }
  }
}

// the block's rows of b_hh (units j0 + u, u < nu), gh = b_hh (h_{-1} = 0) and the carry h = 0
__device__ __forceinline__ void stage_gru_state(float* bhh_s, float* gh_s, float* hown_s,
                                                const float* bhh, int B, int H, int j0, int nu) {
  for (int q = threadIdx.x; q < 3 * kU; q += kThreads) {
    const int g = q / kU, u = q % kU;
    bhh_s[q] = u < nu ? bhh[g * H + j0 + u] : 0.f;
  }
  for (int q = threadIdx.x; q < B * 3 * kU; q += kThreads) {
    const int g = q % (3 * kU) / kU, u = q % kU;
    gh_s[q] = u < nu ? bhh[g * H + j0 + u] : 0.f;
  }
  for (int q = threadIdx.x; q < B * kU; q += kThreads) hown_s[q] = 0.f;
}

// [u][c] = w[c][col0 + u]: a head's first-layer columns of the block's units (0 past nu, FC)
__device__ __forceinline__ void stage_columns(float* w_s, const float* w, int ld, int col0, int nu,
                                              int FC, int FCs) {
  for (int q = threadIdx.x; q < kU * FCs; q += kThreads) {
    const int u = q / FCs, c = q % FCs;
    w_s[q] = u < nu && c < FC ? w[(size_t)c * ld + col0 + u] : 0.f;
  }
}

// [kk][c] = w[k0 + kk][c] and b[k0 + kk]: a head's last layer for the rank's classes (0 past kn, FC)
__device__ __forceinline__ void stage_classes(float* w_s, float* b_s, const float* w, const float* b,
                                              int k0, int kn, int Kc, int FC, int FCs) {
  for (int q = threadIdx.x; q < Kc * FCs; q += kThreads) {
    const int kk = q / FCs, c = q % FCs;
    w_s[q] = kk < kn && c < FC ? w[(size_t)(k0 + kk) * FC + c] : 0.f;
  }
  for (int kk = threadIdx.x; kk < Kc; kk += kThreads) b_s[kk] = kk < kn ? b[k0 + kk] : 0.f;
}

// the GRU cell of unit fu from its input gates (gx0, gx1, gx2) and its gh row
// (r, z, n, kU apart); the carry *own becomes h_t, which is returned
__device__ __forceinline__ float gru_unit(float gx0, float gx1, float gx2, const float* gh, int fu,
                                          float* own) {
  const float rg = sigmoid_f(gx0 + gh[fu]);
  const float zg = sigmoid_f(gx1 + gh[kU + fu]);
  const float ng = tanhf(gx2 + rg * gh[2 * kU + fu]);
  const float hnew = (1.f - zg) * ng + zg * *own;
  *own = hnew;
  return hnew;
}

// the block's partial of first-layer values [pc, pc+4) of a row: its units'
// h (hrow, kU of them) times their columns
__device__ __forceinline__ float4 first_layer_partial(const float* hrow, const float* w_s, int FCs,
                                                      int pc) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);  // units past nu have h = 0 and weights 0
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const float hv = hrow[u];
    const float4 w = load4(w_s + u * FCs + pc);
    s = make_float4(fmaf(hv, w.x, s.x), fmaf(hv, w.y, s.y), fmaf(hv, w.z, s.z), fmaf(hv, w.w, s.w));
  }
  return s;
}

// the rank's n values: the cluster's cs partials (share apart in recv_s)
// summed in rank order, stored at dst with the tag
__device__ __forceinline__ void store_rank_sums(const float* recv_s, int share, int cs, int n,
                                                unsigned long long* dst, unsigned tag) {
  for (int q = threadIdx.x; q < n; q += kThreads) {
    float v[kMaxCluster];  // ranks past cs read rank cs-1 (all loads in flight) and add 0
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) v[r] = recv_s[min(r, cs - 1) * share + q];
    float s = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) s += r < cs ? v[r] : 0.f;
    store_tagged(dst + q, s, tag);
  }
}

// the Gumbel noise of the rank's Kc classes (from k0) of every row at step t:
// Philox counter (t, b, k/4, head), the block's last threads first
__device__ __forceinline__ void draw_noise(float* noise_s, int B, int Kc, int k0, int t,
                                           unsigned head, unsigned seed) {
  for (int q = kThreads - 1 - threadIdx.x; q < B * Kc / 4; q += kThreads) {
    const int b = q / (Kc / 4), kk = 4 * (q % (Kc / 4));
    const uint4 bits = philox4x32_10(make_uint4((unsigned)t, (unsigned)b, (unsigned)(k0 + kk) >> 2, head),
                                     seed, 0u);
    float* g = noise_s + b * Kc + kk;
    g[0] = gumbel(bits.x);
    g[1] = gumbel(bits.y);
    g[2] = gumbel(bits.z);
    g[3] = gumbel(bits.w);
  }
}

// value r of the NC cluster partials (stride apart in stage), summed in a fixed order
__device__ __forceinline__ float sum_partials(const float* stage, int NC, size_t stride, int r) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int c = 0;
#pragma unroll 4
  for (; c + 4 <= NC; c += 4) {
    s0 += stage[(size_t)c * stride + r];
    s1 += stage[(size_t)(c + 1) * stride + r];
    s2 += stage[(size_t)(c + 2) * stride + r];
    s3 += stage[(size_t)(c + 3) * stride + r];
  }
#pragma unroll 1
  for (; c < NC; ++c) s0 += stage[(size_t)c * stride + r];
  return (s0 + s1) + (s2 + s3);
}

// the rank's scores of a head: eight lanes to a (row, class), group grp of
// the block starting at (lb0, lk0) and stepping by kClassGroups tasks
template <int kUnroll>
__device__ __forceinline__ void rank_scores(const float* w_s, const float* b_s, const float* f_s,
                                            const float* noise_s, float* score_s, int B, int Kc,
                                            int kn, int FCs, int lb0, int lk0, int dlb, int dlk,
                                            int sub, bool sampled, float tdiv) {
  for (int base = 0, b = lb0, kk = lk0; base < B * Kc; base += kClassGroups) {
    const bool live = b < B && kk < kn;
    float acc = 0.f;
    if (live) {
#pragma unroll (kUnroll)
      for (int c = 4 * sub; c < FCs; c += 4 * kLanesPerClass)
        acc = dot4(load4(w_s + (size_t)kk * FCs + c), load4(f_s + (size_t)b * FCs + c), acc);
    }
#pragma unroll
    for (int off = kLanesPerClass / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && sub == 0) {
      float s = acc + b_s[kk];
      if (sampled) s = s / tdiv + noise_s[b * Kc + kk];
      score_s[b * Kc + kk] = s;
    }
    b += dlb;
    kk += dlk;
    if (kk >= Kc) {
      kk -= Kc;
      ++b;
    }
  }
}

// the best (score, class) key of a row's kn scores (classes from k0), over the warp
__device__ __forceinline__ unsigned long long row_best_key(const float* score_row, int kn, int k0,
                                                           int lane) {
  unsigned long long key = 0;  // below every (score, class)
  for (int kk = lane; kk < kn; kk += 32) key = max(key, arg_key(score_row[kk], k0 + kk));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
  return key;
}

struct Smem {  // offsets in floats; every array starts on 16 bytes
  size_t stage, h, f, recv, hown, bhh, w1, b1, w2, b2, emb, gh, noise, score, cand, bars,
      total_bytes;
};

__host__ __device__ inline Smem smem_layout(int B, int H, int K, int FC, int cs, int NC,
                                            int stage_rows) {
  const size_t FCs = up4(FC), Kc = up4((K + cs - 1) / cs), U = kU;
  Smem s;
  s.stage = 0;                                      // NC*rows   cluster partials of f, c-major
  s.h = s.stage + (size_t)NC * stage_rows;          // B*Hs      h_t (right after the stage)
  s.f = s.h + (size_t)B * up4(H);                   // B*FCs     relu(h W1^T + b1)
  s.recv = s.f + (size_t)B * FCs;                   // cs*share  the cluster's partials of this rank's f values
  s.hown = s.recv + (size_t)cs * rank_share(B * (int)FCs, cs);  // B*U  own units' h (the carry)
  s.bhh = s.hown + up4((size_t)B * U);              // 3U        own rows of b_hh
  s.w1 = s.bhh + up4(3 * U);                        // U*FCs     [u][c] = W1[c][j0+u]
  s.b1 = s.w1 + U * FCs;                            // B*FCs     b1 of each f value (0 in the padding)
  s.w2 = s.b1 + (size_t)B * FCs;                               // Kc*FCs    [kk][c] = W2[k0+kk][c]
  s.b2 = s.w2 + Kc * FCs;                           // Kc
  s.emb = s.b2 + Kc;                                // K*3U      [k][g*U+u] = emb[k][g*H+j0+u]
  s.gh = s.emb + up4((size_t)K * 3 * U);            // B*3U      own gate rows of h Whh^T + b_hh
  s.noise = s.gh + up4((size_t)B * 3 * U);          // B*Kc      Gumbel noise of the coming sample
  s.score = s.noise + (size_t)B * Kc;               // B*Kc      scores of the rank's classes
  s.cand = s.score + (size_t)B * Kc;                // B*cs*2    every rank's best key of each row
  s.bars = s.cand + up4((size_t)B * cs * 2);        // 2 mbarriers (8 bytes each)
  s.total_bytes = (s.bars + 4) * sizeof(float);
  return s;
}

__global__ void __launch_bounds__(kThreads) wavernn_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  constexpr int U = kU;
  const int B = a.B, T = a.T, H = a.H, K = a.K, FC = a.FC, cs = a.cs;
  const int Hs = a.Hs, FCs = a.FCs, Kc = a.Kc, BFs = B * FCs;
  const size_t H3 = 3 * (size_t)H;
  const int NC = gridDim.x / cs, k = blockIdx.x, j0 = k * U;
  const int rank = (int)cluster.block_rank(), cid = k / cs;
  const int nu = max(0, min(U, H - j0));  // units this block owns (0 in padding blocks)
  const int k0 = rank * Kc, kn = max(0, min(Kc, K - k0));  // the rank's classes
  const int share = rank_share(BFs, cs), lo = rank * share, hi = min(BFs, lo + share);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool sampled = a.temp > 0.f;
  const float tdiv = fmaxf(a.temp, 1e-6f);
  const Smem L = smem_layout(B, H, K, FC, cs, NC, a.stage_rows);

  float* h_s = smem + L.h;
  float* stage = smem + L.stage;
  float* f_s = smem + L.f;
  float* recv_s = smem + L.recv;
  float* hown_s = smem + L.hown;
  float* bhh_s = smem + L.bhh;
  float* w1_s = smem + L.w1;
  float* b1_s = smem + L.b1;
  float* w2_s = smem + L.w2;
  float* b2_s = smem + L.b2;
  float* emb_s = smem + L.emb;
  float* gh_s = smem + L.gh;
  float* noise_s = smem + L.noise;
  float* score_s = smem + L.score;
  unsigned long long* cand_s = reinterpret_cast<unsigned long long*>(smem + L.cand);
  const unsigned bar_part = smem_addr(smem + L.bars), bar_cand = bar_part + 8;
  const unsigned part_bytes = (unsigned)(cs * max(0, hi - lo) * 4), cand_bytes = (unsigned)(cs * B * 8);

  // ---- weights into registers and shared memory, once per call ----
  float4 wreg[3][kRegIters];  // Whh rows g*H + j0 + warp, float4 it at 128*it + 4*lane
  if (warp < nu) load_whh(wreg, a.whh, H, j0 + warp, lane);
  stage_columns(w1_s, a.w1, H, j0, nu, FC, FCs);
  stage_classes(w2_s, b2_s, a.w2, a.b2, k0, kn, Kc, FC, FCs);
  for (int q = threadIdx.x; q < BFs; q += kThreads) b1_s[q] = q % FCs < FC ? a.b1[q % FCs] : 0.f;
  for (int q = threadIdx.x; q < K * 3 * U; q += kThreads) {
    const int kk = q / (3 * U), g = q % (3 * U) / U, u = q % U;
    emb_s[q] = u < nu ? a.emb[(size_t)kk * H3 + g * H + j0 + u] : 0.f;
  }
  stage_gru_state(bhh_s, gh_s, hown_s, a.bhh, B, H, j0, nu);
  if (threadIdx.x == 0) {
    mbar_init(bar_part);
    mbar_init(bar_cand);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_part, part_bytes);  // phase 0 of each: step 0's data
    mbar_expect(bar_cand, cand_bytes);
  }

  // thread q < B*U finishes unit u = q % U of row b = q / U; its conditioning
  // gates of the coming step wait in registers
  const int fb = threadIdx.x / U, fu = threadIdx.x % U;
  const bool finisher = threadIdx.x < B * U && fu < nu;
  const bool hpad = threadIdx.x < B * U && fu >= nu && j0 + fu < Hs;  // writes the row padding's 0
  const int XW = NC * BFs + B * Hs;  // words of one step's exchange: the partials, then h
  unsigned* count = reinterpret_cast<unsigned*>(a.xbuf + 2 * (size_t)XW);
  float cx[3] = {0.f, 0.f, 0.f};
  if (finisher) {
    const float* row = a.gates + (size_t)fb * T * H3 + j0 + fu;
#pragma unroll
    for (int g = 0; g < 3; ++g) cx[g] = __ldg(row + g * H);
  }
  // the step loop's index arithmetic, once: thread q < BFs/4 owns f values
  // [4q, 4q+4) of the block's partial (one group a thread: BFs <= 4*kThreads)
  const int pq = 4 * threadIdx.x, pb = pq / FCs, pc = pq % FCs, powner = pq / share;
  const bool pushes = pq < BFs;
  const unsigned pdst = remote(smem_addr(recv_s + rank * share + (pq - powner * share)), pushes ? powner : 0);
  const unsigned pbar = remote(bar_part, pushes ? powner : 0);
  // the logits: group grp of 8 lanes scores (row, class) (lb, lk), then
  // steps by kClassGroups tasks
  const int grp = threadIdx.x / kLanesPerClass, sub = threadIdx.x % kLanesPerClass;
  const int lb0 = grp / Kc, lk0 = grp % Kc, dlb = kClassGroups / Kc, dlk = kClassGroups % Kc;
  cluster.sync();  // every block of the cluster runs, with its mbarriers set

#ifdef WAVERNN_PROFILE
  __shared__ long long prof_s[kPhases];  // summed here, added to g_prof at the end
  if (threadIdx.x < kPhases) prof_s[threadIdx.x] = 0;
  __syncthreads();
  long long prof_t = clock64();
#endif
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const unsigned tag = (unsigned)t + 1;  // the scratch words are 0 at launch
    unsigned long long* xdst = a.xbuf + (size_t)cur * XW;

    // ---- the sample of step t-1 (the best of the cluster's candidates), gates and h_t ----
    if (t > 0 && (finisher || threadIdx.x == 0)) {
      mbar_wait(bar_cand, (t - 1) & 1);
      if (threadIdx.x == 0) mbar_expect(bar_cand, cand_bytes);  // the next phase: step t's
    }
    PROF_MARK(0);
    if (finisher) {
      int idx = K / 2;
      if (t > 0) {
        idx = key_index(best_candidate(cand_s + fb * cs, cs));
        if (k == 0 && fu == 0) a.out[(size_t)fb * T + (t - 1)] = idx;
      }
      const float* e = emb_s + (size_t)idx * 3 * U;
      const float hnew = gru_unit(cx[0] + e[fu], cx[1] + e[U + fu], cx[2] + e[2 * U + fu],
                                  gh_s + fb * 3 * U, fu, hown_s + threadIdx.x);
      store_tagged(xdst + NC * BFs + (size_t)fb * Hs + j0 + fu, hnew, tag);
    } else if (hpad) {
      store_tagged(xdst + NC * BFs + (size_t)fb * Hs + j0 + fu, 0.f, tag);
    }
    __syncthreads();
    PROF_MARK(1);

    // ---- this block's partial of f = h_t . W1^T, 4 values to a thread, pushed to their rank ----
    if (pushes) push4(pdst, first_layer_partial(hown_s + pb * U, w1_s, FCs, pc), pbar);
    PROF_MARK(2);

    // ---- this rank's f values: the cluster's cs partials in rank order, stored with the tag ----
    mbar_wait(bar_part, cur);
    if (threadIdx.x == 0) mbar_expect(bar_part, part_bytes);  // the next phase: step t+1's
    PROF_MARK(3);
    store_rank_sums(recv_s, share, cs, hi - lo, xdst + (size_t)cid * BFs + lo, tag);
    if (finisher && t + 1 < T) {  // the next step's conditioning gates, in flight from here
      const float* row = a.gates + ((size_t)fb * T + t + 1) * H3 + j0 + fu;
#pragma unroll
      for (int g = 0; g < 3; ++g) cx[g] = __ldg(row + g * H);
    }
    __syncthreads();
    if (threadIdx.x == 0) add_count(count);  // a hint: the tags decide
    PROF_MARK(4);

    // ---- the noise of the coming sample (it depends on (seed, t, b, k) only),
    // drawn while thread 0 waits for every block to have stored this step ----
    if (sampled) draw_noise(noise_s, B, Kc, k0, t, 0u, a.seed);
    if (threadIdx.x == 0) wait_count(count, (unsigned)gridDim.x * tag);
    __syncthreads();
    PROF_MARK(5);

    // ---- the NC cluster partials of f and h_t, polled until they carry the tag ----
    const unsigned long long* xsrc = xdst;
    for (int r0 = 0; r0 < BFs; r0 += a.stage_rows) {
      const int n = min(a.stage_rows, BFs - r0), n2 = n / 2;
      const int np = NC * n2, nh = r0 == 0 ? B * Hs / 2 : 0;  // word pairs of partials, of h
      for (int base = 0; base < np + nh; base += kPoll * kThreads) {
        // pair i = base + threadIdx.x + j * kThreads: partials (c, rp) = divmod(i, n2)
        // while i < np, then h pair i - np; offsets in words of xsrc and floats
        // of stage (h_s follows it).  With one pass (n == BFs) both layouts are
        // the exchange's own: pair i is word 2i and float 2i.
        int src[kPoll], dst[kPoll];
        unsigned ready = 0;  // bit j: pair j needs no further load
#pragma unroll
        for (int j = 0; j < kPoll; ++j) {
          const int i = base + threadIdx.x + j * kThreads;
          if (i >= np + nh) {
            src[j] = dst[j] = 0;
            ready |= 1u << j;
          } else if (n == BFs) {
            src[j] = dst[j] = 2 * i;
          } else if (i < np) {
            src[j] = (i / n2) * BFs + r0 + 2 * (i % n2);
            dst[j] = (i / n2) * n + 2 * (i % n2);
          } else {
            src[j] = NC * BFs + 2 * (i - np);
            dst[j] = NC * a.stage_rows + 2 * (i - np);
          }
        }
        // the loads, in the kernel's own loop: the same loop in a device
        // function, inlined, costs K4 ~200 cycles a step (3.5%)
        ulonglong2 w[kPoll];
        const long long start = clock64();
        for (;;) {
#pragma unroll
          for (int j = 0; j < kPoll; ++j)
            if (!(ready >> j & 1)) w[j] = load_tagged2(xsrc + src[j]);
#pragma unroll
          for (int j = 0; j < kPoll; ++j) {
            if (!(ready >> j & 1) && tag_of(w[j].x) == tag && tag_of(w[j].y) == tag) {
              ready |= 1u << j;
              *reinterpret_cast<float2*>(stage + dst[j]) = make_float2(value_of(w[j].x), value_of(w[j].y));
            }
          }
          if (ready == (1u << kPoll) - 1) break;
          spin_guard(start);
        }
      }
      PROF_MARK(6);
      __syncthreads();
#pragma unroll 1
      for (int r = threadIdx.x; r < n; r += kThreads)  // the NC partials in a fixed order
        // padding values: partials of zero W1 columns, +0, and b1 0 there
        f_s[r0 + r] = fmaxf(sum_partials(stage, NC, n, r) + b1_s[r0 + r], 0.f);
      __syncthreads();  // the stage is refilled by the next pass; f_s before the logits
    }
    PROF_MARK(7);

    // ---- the rank's logits: eight lanes to a (row, class) ----
    rank_scores<4>(w2_s, b2_s, f_s, noise_s, score_s, B, Kc, kn, FCs, lb0, lk0, dlb, dlk, sub,
                   sampled, tdiv);
    __syncthreads();
    PROF_MARK(8);

    // ---- the rank's best (score, class) of each row, pushed to every rank of the cluster ----
    for (int b = warp; b < B; b += kWarps) {
      const unsigned long long key = row_best_key(score_s + b * Kc, kn, k0, lane);
      PROF_MARK(9);
      if (lane < cs) push_key(remote(smem_addr(cand_s + b * cs + rank), lane), key, remote(bar_cand, lane));
    }
    PROF_MARK(10);

    // ---- while the candidates cross the cluster: gh = h_t . Whh^T + b_hh ----
    if (warp < nu && t + 1 < T) {
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        if (B - b0 == 1) gate_dots<1>(wreg, h_s, bhh_s, gh_s, B, H, Hs, b0, warp, lane);
        else gate_dots<kBatchChunk>(wreg, h_s, bhh_s, gh_s, B, H, Hs, b0, warp, lane);
      }
    }
    __syncthreads();  // gh_s before the finishers; h_s read before it is refilled
    PROF_MARK(11);
  }

  // ---- the last sample; no block leaves while st.async data is still due to it ----
  mbar_wait(bar_cand, (T - 1) & 1);
  if (k == 0) {
    for (int b = threadIdx.x; b < B; b += kThreads)
      a.out[(size_t)b * T + (T - 1)] = key_index(best_candidate(cand_s + b * cs, cs));
  }
  cluster.sync();
#ifdef WAVERNN_PROFILE
  if (blockIdx.x == 0 && threadIdx.x < kPhases) g_prof[threadIdx.x] += prof_s[threadIdx.x];
#endif
}

cudaLaunchConfig_t launch_config(int grid, int smem, cudaLaunchAttribute* attrs, int cs,
                                 bool cooperative, cudaStream_t stream) {
  cudaLaunchConfig_t c = {};
  c.gridDim = dim3(grid);
  c.blockDim = dim3(kThreads);
  c.dynamicSmemBytes = (size_t)smem;
  c.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  c.attrs = attrs;
  c.numAttrs = cooperative ? 2 : 1;
  return c;
}

int plan(int B, int H, int K, int FC, int* grid, int* units, int* cluster, int* stage_rows,
         int* smem) {
  if (B < 1 || H < 1 || K < 1 || FC < 1 || H > 128 * kRegIters) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e != cudaSuccess) return e;
  // U = 8: one warp per unit and every warp busy; a finishing thread per
  // (row, unit), so B*U <= kThreads
  const int U = kU, G = (H + U - 1) / U;
  if ((long long)B * U > kThreads || (long long)B * up4(FC) > 4 * kThreads) return cudaErrorInvalidValue;
  // the largest cluster whose grid stays resident; the f stage takes what
  // shared memory is left, up to all B*FC values
  for (int cs = kMaxCluster; cs >= 1; cs /= 2) {
    const int Gp = (G + cs - 1) / cs * cs, NC = Gp / cs;
    const size_t base = smem_layout(B, H, K, FC, cs, NC, 0).total_bytes;
    const size_t row_bytes = (size_t)NC * sizeof(float);
    if (base + 4 * row_bytes > (size_t)optin) continue;
    const int rows = (int)std::min(up4((size_t)B * up4(FC)), (optin - base) / row_bytes / 4 * 4);
    const size_t s = smem_layout(B, H, K, FC, cs, NC, rows).total_bytes;
    e = cudaFuncSetAttribute(wavernn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t c = launch_config(Gp, (int)s, attrs, cs, false, nullptr);
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, wavernn_kernel, &c);
    if (e != cudaSuccess) return e;
    if (active < NC) continue;
    *grid = Gp;
    *units = U;
    *cluster = cs;
    *stage_rows = rows;
    *smem = (int)s;
    return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;  // W2's slice, h or the grid does not fit
}

// ---- the dual instantiation (see the head of this file) ----

struct DualArgs {
  const float* gates;  // (B, T, 3H) conditioning gates, b_ih included
  const float* win;    // (3H, 3)    masked weights of [c~_{t-1}, f~_{t-1}, c~_t]
  const float* whh;    // (3H, H)
  const float* bhh;    // (3H)
  const float* o1;     // (Hh, Hh)  coarse head
  const float* b1;     // (Hh)
  const float* o2;     // (K, Hh)
  const float* b2;     // (K)
  const float* o3;     // (Hh, Hh)  fine head
  const float* b3;     // (Hh)
  const float* o4;     // (K, Hh)
  const float* b4;     // (K)
  int* out;            // (B, T) c * 256 + f
  // (2 heads, 2 parities, XW) tagged words: the head's first layer,
  // summed in each cluster of its half, by the rank that owns the values
  // ([rank][cluster][b][c], B*Cs words each, 0 past the rank's values), then
  // the half's h (B rows of Hh)
  unsigned long long* xbuf;
  unsigned seed;
  float temp;
  int B, T, H, K, cs;
  int Ghp;             // blocks of one half, a multiple of cs
  int Kc;              // classes of a rank (a multiple of 4)
};

// first-layer values of a row that a rank owns (the last ranks may own
// fewer, or none), and the row stride of its slice of O2 / O4 in shared
// memory (an odd number of float4s: eight lanes' float4 loads of eight
// classes fall in distinct banks)
__host__ __device__ inline int dual_share(int Hh, int cs) { return (int)up4((Hh + cs - 1) / cs); }
__host__ __device__ inline int dual_w2_stride(int Cs) { return Cs / 4 % 2 ? Cs : Cs + 4; }
// each lane's Whh sums of the first rows, carried across a phase's wait: [u][row][g][lane]
__host__ __device__ inline size_t dual_acc_floats(int B) { return (size_t)kU * (B < kBatchChunk ? B : kBatchChunk) * 3 * 32; }

struct DualSmem {  // offsets in floats; every array starts on 16 bytes
  size_t stage, h, f, recv, lrecv, hown, bhh, win, cx, w1, b1, w2, b2, gh, acc, noise, cand, bars,
      total_bytes;
};

__host__ __device__ inline DualSmem dual_smem_layout(int B, int H, int K, int cs, int NCh) {
  const size_t Hh = H / 2, Kc = up4((K + cs - 1) / cs), U = kU, Cs = dual_share((int)Hh, cs);
  const size_t SW = B * Cs, Ws = dual_w2_stride((int)Cs);
  DualSmem s;
  s.stage = 0;                                       // NCh*SW   the rank's values, as each cluster summed them
  s.h = s.stage + NCh * SW;                          // B*H      h_t, both halves
  s.f = s.h + (size_t)B * H;                         // SW       relu(y O^T + b) of the rank's values
  s.recv = s.f + SW;                                 // cs*SW    the cluster's partials of the rank's values
  s.lrecv = s.recv + cs * SW;                        // cs*B*Kc  every rank's partial logits of this rank's classes
  s.hown = s.lrecv + cs * B * Kc;                    // B*U      own units' h (the carry)
  s.bhh = s.hown + up4((size_t)B * U);               // 3U       own rows of b_hh
  s.win = s.bhh + up4(3 * U);                        // 9U       [g][i][u] = win[g*H+j0+u][i]
  s.cx = s.win + up4(9 * U);                         // 3*B*U    [g][thread] the next step's conditioning gates
  s.w1 = s.cx + up4(3 * (size_t)B * U);              // U*Hh     [u][c] = O[c][jl+u] of the block's half
  s.b1 = s.w1 + U * Hh;                              // 2*SW     [head][b][cc] = b1|b3[c0+cc]
  s.w2 = s.b1 + 2 * SW;                              // 2*K*Ws   [head][k][cc] = O2|O4[k][c0+cc]
  s.b2 = s.w2 + 2 * (size_t)K * Ws;                  // 2*Kc     b2, b4 of the rank's classes
  s.gh = s.b2 + 2 * Kc;                              // B*3U     own gate rows of h Whh^T + b_hh
  s.acc = s.gh + up4((size_t)B * 3 * U);             // U*R*3*32 each lane's Whh sums of rows [0, R), R = min(B, 4)
  s.noise = s.acc + dual_acc_floats(B);              // B*Kc     Gumbel noise of the rank's classes
  s.cand = s.noise + (size_t)B * Kc;                 // 2*B*cs*2 every rank's best key of each row, per head
  s.bars = s.cand + 2 * up4((size_t)B * cs * 2);     // 4 mbarriers (8 bytes each)
  s.total_bytes = (s.bars + 8) * sizeof(float);
  return s;
}

__device__ __forceinline__ float scaled_byte(int v) { return __fsub_rn(__fdiv_rn((float)v, 127.5f), 1.0f); }

// gate_dots<R> for the dual in parts: each lane's sums of its unit's three
// Whh rows over the columns [i0, i1) of h, for the rows b0 + c (rows past
// B repeat row B-1), from 0 (kFrom0) or from acc ([row][g][lane] of the
// warp's, the lane's own words), then stored there or (kFinish) summed over
// the warp into gh_s as gate_dots ends.  A lane meets its float4s in
// gate_dots' order, so [0, Hh) then [Hh, H) gives its gh bit for bit.
template <int R, bool kFrom0, bool kFinish>
__device__ __forceinline__ void whh_part(const float4 (&wreg)[3][kRegIters], const float* h_s,
                                         float* acc, const float* bhh_s, float* gh_s, int B, int H,
                                         int i0, int i1, int b0, int u, int lane) {
  int row[R];
#pragma unroll
  for (int c = 0; c < R; ++c) row[c] = min(b0 + c, B - 1);
  float sum[3][R];
#pragma unroll
  for (int c = 0; c < R; ++c)
#pragma unroll
    for (int g = 0; g < 3; ++g) sum[g][c] = kFrom0 ? 0.f : acc[(3 * row[c] + g) * 32 + lane];
#pragma unroll
  for (int it = 0; it < kRegIters; ++it) {
    const int i = 128 * it + 4 * lane;
    if (i >= i0 && i < i1) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(h_s + (size_t)row[c] * H + i);
#pragma unroll
        for (int g = 0; g < 3; ++g) sum[g][c] = dot4(wreg[g][it], v, sum[g][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    if (kFinish) {
      const float s0 = warp_sum(sum[0][c]), s1 = warp_sum(sum[1][c]), s2 = warp_sum(sum[2][c]);
      if (lane == 0 && b0 + c < B) {
        float* gh = gh_s + (b0 + c) * 3 * kU;
        gh[u] = s0 + bhh_s[u];
        gh[kU + u] = s1 + bhh_s[kU + u];
        gh[2 * kU + u] = s2 + bhh_s[2 * kU + u];
      }
    } else {  // a repeated row writes its row's sums again
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[(3 * row[c] + g) * 32 + lane] = sum[g][c];
    }
  }
}

// the dual's gh of unit u (its Whh rows in wreg) from h_s (B rows of H):
// each lane's sums of rows [0, kBatchChunk) over the coarse columns [0, Hh)
// into acc_s (dual_acc_floats), then carried on over the fine columns and
// finished, further rows whole
__device__ __forceinline__ void gh_coarse(const float4 (&wreg)[3][kRegIters], const float* h_s,
                                          float* acc_s, int B, int H, int u, int lane) {
  float* acc = acc_s + (size_t)u * min(B, kBatchChunk) * 3 * 32;
  if (B == 1) whh_part<1, true, false>(wreg, h_s, acc, nullptr, nullptr, B, H, 0, H / 2, 0, u, lane);
  else whh_part<kBatchChunk, true, false>(wreg, h_s, acc, nullptr, nullptr, B, H, 0, H / 2, 0, u, lane);
}
__device__ __forceinline__ void gh_fine(const float4 (&wreg)[3][kRegIters], const float* h_s,
                                        float* acc_s, const float* bhh_s, float* gh_s, int B, int H,
                                        int u, int lane) {
  float* acc = acc_s + (size_t)u * min(B, kBatchChunk) * 3 * 32;
  if (B == 1) whh_part<1, false, true>(wreg, h_s, acc, bhh_s, gh_s, B, H, H / 2, H, 0, u, lane);
  else whh_part<kBatchChunk, false, true>(wreg, h_s, acc, bhh_s, gh_s, B, H, H / 2, H, 0, u, lane);
  for (int b0 = kBatchChunk; b0 < B; b0 += kBatchChunk) {
    if (B - b0 == 1) gate_dots<1>(wreg, h_s, bhh_s, gh_s, B, H, H, b0, u, lane);
    else gate_dots<kBatchChunk>(wreg, h_s, bhh_s, gh_s, B, H, H, b0, u, lane);
  }
}

// the Gumbel noise draw_noise gives class k of row b at step t: word k % 4 of
// the Philox counter (t, b, k / 4, head)
__device__ __forceinline__ float class_noise(int t, int b, int k, unsigned head, unsigned seed) {
  const uint4 bits = philox4x32_10(make_uint4((unsigned)t, (unsigned)b, (unsigned)k >> 2, head), seed, 0u);
  const int w = k & 3;
  return gumbel(w == 0 ? bits.x : w == 1 ? bits.y : w == 2 ? bits.z : bits.w);
}

// 4 bytes global -> shared, asynchronous (cp.async.wait_all before reading them)
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem_dst)), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void push1(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(dst),
               "f"(v), "r"(bar)
               : "memory");
}

// the rank's partial logits of a head for the rows b0 + c (rows past B
// repeat row B-1): over its values of each row (f_s, Cs apart), every class
// (w_s, Ws apart), a thread to a class; each pushed to the class's owner
// rank, [rank][b][kk] of its lrecv_s, counted by its bar_logit
template <int R>
__device__ __forceinline__ void push_share_logits(const float* w_s, const float* f_s, float* lrecv_s,
                                                  unsigned bar_logit, int B, int K, int Kc, int Cs,
                                                  int Ws, int b0, int rank) {
  int row[R];
#pragma unroll
  for (int c = 0; c < R; ++c) row[c] = min(b0 + c, B - 1);
  for (int kk = threadIdx.x; kk < K; kk += kThreads) {
    float acc[R];
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < Cs; cc += 4) {
      const float4 w = load4(w_s + (size_t)kk * Ws + cc);
#pragma unroll
      for (int c = 0; c < R; ++c) acc[c] = dot4(w, load4(f_s + (size_t)row[c] * Cs + cc), acc[c]);
    }
    const int owner = kk / Kc, kl = kk - owner * Kc;
#pragma unroll
    for (int c = 0; c < R; ++c)
      if (b0 + c < B)
        push1(remote(smem_addr(lrecv_s + ((size_t)rank * B + b0 + c) * Kc + kl), owner), acc[c],
              remote(bar_logit, owner));
  }
}

__global__ void __launch_bounds__(kThreads) wavernn_kernel_dual(DualArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  constexpr int U = kU;
  const int B = a.B, T = a.T, H = a.H, K = a.K, cs = a.cs, Kc = a.Kc;
  const int Hh = H / 2, BFs = B * Hh;  // H % 8 == 0: Hh a multiple of 4
  const size_t H3 = 3 * (size_t)H;
  const int k = blockIdx.x, half = k / a.Ghp, kl = k % a.Ghp;
  const int jl = kl * U, j0 = half * Hh + jl;  // the block's first unit in its half, in h
  const int NCh = a.Ghp / cs, cid = kl / cs;   // clusters of a half; this block's among them
  const int rank = (int)cluster.block_rank();
  const int nu = max(0, min(U, Hh - jl));      // units this block owns (0 in padding blocks)
  const int k0 = rank * Kc, kn = max(0, min(Kc, K - k0));  // the rank's classes
  // the rank's first-layer values of each row: [c0, c0 + nc) of Cs, SW words a row set
  const int Cs = dual_share(Hh, cs), c0 = rank * Cs, nc = max(0, min(Cs, Hh - c0));
  const int SW = B * Cs, Ws = dual_w2_stride(Cs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool sampled = a.temp > 0.f;
  const float tdiv = fmaxf(a.temp, 1e-6f);
  const DualSmem L = dual_smem_layout(B, H, K, cs, NCh);

  float* stage = smem + L.stage;
  float* h_s = smem + L.h;
  float* f_s = smem + L.f;
  float* recv_s = smem + L.recv;
  float* lrecv_s = smem + L.lrecv;
  float* hown_s = smem + L.hown;
  float* bhh_s = smem + L.bhh;
  float* win_s = smem + L.win;
  float* w1_s = smem + L.w1;
  float* b1_s = smem + L.b1;
  float* w2_s = smem + L.w2;
  float* b2_s = smem + L.b2;
  float* gh_s = smem + L.gh;
  float* cx_s = smem + L.cx;
  float* acc_s = smem + L.acc;
  float* noise_s = smem + L.noise;
  unsigned long long* cand_s[2] = {reinterpret_cast<unsigned long long*>(smem + L.cand),
                                   reinterpret_cast<unsigned long long*>(smem + L.cand + up4((size_t)B * cs * 2))};
  const unsigned bar_part = smem_addr(smem + L.bars);
  const unsigned bar_cand[2] = {bar_part + 8, bar_part + 16};
  const unsigned bar_logit = bar_part + 24;
  const unsigned part_bytes = (unsigned)(cs * B * nc * 4), logit_bytes = (unsigned)(cs * B * kn * 4);
  const unsigned cand_bytes = (unsigned)(cs * B * 8);

  // ---- weights into registers and shared memory, once per call ----
  float4 wreg[3][kRegIters];  // Whh rows g*H + j0 + warp, float4 it at 128*it + 4*lane
  if (warp < nu) load_whh(wreg, a.whh, H, j0 + warp, lane);
  stage_columns(w1_s, half ? a.o3 : a.o1, Hh, jl, nu, Hh, Hh);
  for (int q = threadIdx.x; q < 2 * K * Ws; q += kThreads) {
    const int head = q / (K * Ws), kk = q / Ws % K, cc = q % Ws;
    w2_s[q] = cc < nc ? (head ? a.o4 : a.o2)[(size_t)kk * Hh + c0 + cc] : 0.f;
  }
  for (int q = threadIdx.x; q < 2 * Kc; q += kThreads) {
    const int kk = q % Kc;
    b2_s[q] = kk < kn ? (q < Kc ? a.b2 : a.b4)[k0 + kk] : 0.f;
  }
  for (int q = threadIdx.x; q < 2 * SW; q += kThreads) {
    const int cc = q % Cs;
    b1_s[q] = cc < nc ? (q < SW ? a.b1 : a.b3)[c0 + cc] : 0.f;
  }
  for (int q = threadIdx.x; q < cs * SW; q += kThreads) recv_s[q] = 0.f;  // past nc: never pushed
  for (int q = threadIdx.x; q < 9 * U; q += kThreads) {
    const int g = q / (3 * U), i = q / U % 3, u = q % U;
    win_s[q] = u < nu ? a.win[(size_t)(g * H + j0 + u) * 3 + i] : 0.f;
  }
  stage_gru_state(bhh_s, gh_s, hown_s, a.bhh, B, H, j0, nu);
  if (threadIdx.x == 0) {
    mbar_init(bar_part);
    mbar_init(bar_cand[0]);
    mbar_init(bar_cand[1]);
    mbar_init(bar_logit);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_part, part_bytes);  // phase 0 of each: step 0's data
    mbar_expect(bar_cand[0], cand_bytes);
    mbar_expect(bar_cand[1], cand_bytes);
    mbar_expect(bar_logit, logit_bytes);
  }

  // thread q < B*U finishes unit u = q % U of row b = q / U in its half's
  // phase; it keeps the row's samples: c_{t-1}, f_{t-1} and, in phase 1, c_t
  const int fb = threadIdx.x / U, fu = threadIdx.x % U;
  const bool finisher = threadIdx.x < B * U && fu < nu;
  const size_t PW = (size_t)a.Ghp * SW;  // words of a head's first layer: cs ranks x NCh clusters x SW
  const size_t XW = PW + (size_t)B * Hh;  // words of one head's exchange of a step
  const size_t own = (size_t)rank * NCh * SW;  // the rank's words: its values from every cluster
  // its conditioning gates of the coming step, copied to shared memory a step ahead
  // (held in registers, they were spilled, and the spill waited for the load)
  float* cx_own = cx_s + threadIdx.x;  // g at g*B*U
  if (finisher) {
    const float* row = a.gates + (size_t)fb * T * H3 + j0 + fu;
#pragma unroll
    for (int g = 0; g < 3; ++g) cp_async4(cx_own + g * B * U, row + g * H);
  }
  int cprev = K / 2, fprev = 0, cnow = K / 2;
  cluster.sync();  // every block of the cluster runs, with its mbarriers set

#ifdef WAVERNN_PROFILE
  __shared__ long long prof_s[2 * kDualMarks];  // summed here, added to g_prof_dual at the end
  if (threadIdx.x < 2 * kDualMarks) prof_s[threadIdx.x] = 0;
  __syncthreads();
  long long prof_t = clock64();
  unsigned long long stale[2] = {0, 0};
#endif
  for (int t = 0; t < T; ++t) {
    const unsigned tag = (unsigned)t + 1;  // the scratch words are 0 at launch
#pragma unroll 1
    for (int p = 0; p < 2; ++p) {
      unsigned long long* xdst = a.xbuf + (2 * p + (t & 1)) * XW;

      // ---- the sample this phase waits for: f_{t-1} (phase 0) or c_t (phase 1) ----
      if ((p == 1 || t > 0) && (finisher || threadIdx.x == 0)) {
        const unsigned bar = bar_cand[1 - p];
        mbar_wait(bar, p ? (t & 1) : ((t - 1) & 1));
        if (threadIdx.x == 0) mbar_expect(bar, cand_bytes);  // the next phase: a step later
      }
      if (finisher && (p == 1 || t > 0)) {
        const int s = key_index(best_candidate(cand_s[1 - p] + fb * cs, cs));
        if (p == 1) {
          cnow = s;
        } else {
          if (k == 0 && fu == 0) a.out[(size_t)fb * T + (t - 1)] = (cnow << 8) | s;
          cprev = cnow;
          fprev = s;
        }
      }
      DUAL_MARK(0);

      if (half == p) {
        // ---- the half's units of h_t ----
        if (finisher) {
          const float x0 = scaled_byte(cprev), x1 = scaled_byte(fprev), x2 = scaled_byte(p ? cnow : cprev);
          cp_async_wait_all();  // issued a step ago
          float gx[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float* w = win_s + g * 3 * U + fu;
            gx[g] = __fadd_rn(__fadd_rn(__fadd_rn(cx_own[g * B * U], __fmul_rn(x0, w[0])), __fmul_rn(x1, w[U])),
                              __fmul_rn(x2, w[2 * U]));
          }
          const float hnew = gru_unit(gx[0], gx[1], gx[2], gh_s + fb * 3 * U, fu, hown_s + threadIdx.x);
          store_tagged(xdst + PW + (size_t)fb * Hh + jl + fu, hnew, tag);
        }
        __syncthreads();
        DUAL_MARK(1);

        // ---- this block's partial of the head's first layer, 4 values to a thread, to their owner ----
        for (int pq = 4 * threadIdx.x; pq < BFs; pq += 4 * kThreads) {
          const int pb = pq / Hh, pc = pq % Hh, owner = pc / Cs;
          push4(remote(smem_addr(recv_s + (rank * B + pb) * Cs + pc - owner * Cs), owner),
                first_layer_partial(hown_s + pb * U, w1_s, Hh, pc), remote(bar_part, owner));
        }
        DUAL_MARK(2);

        // ---- this rank's values: the cluster's cs partials in rank order, stored with the tag ----
        mbar_wait(bar_part, t & 1);
        DUAL_MARK(3);
        store_rank_sums(recv_s, SW, cs, SW, xdst + own + (size_t)cid * SW, tag);
        if (finisher && t + 1 < T) {  // the next step's conditioning gates, in flight from here
          const float* row = a.gates + ((size_t)fb * T + t + 1) * H3 + j0 + fu;
#pragma unroll
          for (int g = 0; g < 3; ++g) cp_async4(cx_own + g * B * U, row + g * H);
        }
      }
      DUAL_MARK(4);

      // ---- the noise of the rank's classes, drawn by the lanes that score them (a warp to
      // a row), before the phase's values can have arrived ----
      if (sampled)
        for (int b = warp; b < B; b += kWarps)
          for (int kk = lane; kk < Kc; kk += 32) noise_s[b * Kc + kk] = class_noise(t, b, k0 + kk, (unsigned)p, a.seed);
      DUAL_MARK(5);

      // ---- the rank's values from the NCh clusters and the half's h_t (its Whh products
      // wait for it at the phase's end, not the sample), polled until they carry the
      // tag: no count of the stores first (a round trip through L2 more), and no
      // reader passes a phase before its cluster has merged the last one's samples,
      // so buffers are reused in order ----
      const int np = NCh * SW / 2, nh = t + 1 < T ? B * Hh / 2 : 0;  // word pairs of values, of h
      for (int base = 0; base < np + nh; base += kPoll * kThreads) {
        int src[kPoll], dst[kPoll];  // words of xdst, floats of smem
        unsigned ready = 0;  // bit j: pair j needs no further load
#pragma unroll
        for (int j = 0; j < kPoll; ++j) {
          const int i = base + threadIdx.x + j * kThreads;
          if (i >= np + nh) {
            src[j] = dst[j] = 0;
            ready |= 1u << j;
          } else if (i < np) {
            src[j] = (int)own + 2 * i;
            dst[j] = (int)L.stage + 2 * i;
          } else {
            const int w = 2 * (i - np);
            src[j] = (int)PW + w;
            dst[j] = (int)L.h + w / Hh * H + p * Hh + w % Hh;
          }
        }
        ulonglong2 w[kPoll];  // K4's loads (kept in each kernel: see there)
        const long long start = clock64();
        for (;;) {
#pragma unroll
          for (int j = 0; j < kPoll; ++j)
            if (!(ready >> j & 1)) w[j] = load_tagged2(xdst + src[j]);
#pragma unroll
          for (int j = 0; j < kPoll; ++j) {
            if (!(ready >> j & 1) && tag_of(w[j].x) == tag && tag_of(w[j].y) == tag) {
              ready |= 1u << j;
              *reinterpret_cast<float2*>(smem + dst[j]) = make_float2(value_of(w[j].x), value_of(w[j].y));
            }
          }
          if (ready == (1u << kPoll) - 1) break;
#ifdef WAVERNN_PROFILE
          ++stale[p];
#endif
          spin_guard(start);
        }
      }
      DUAL_MARK(6);
      __syncthreads();
#pragma unroll 1
      for (int q = threadIdx.x; q < SW; q += kThreads)  // the NCh clusters' sums in a fixed order
        f_s[q] = fmaxf(sum_partials(stage, NCh, SW, q) + b1_s[p * SW + q], 0.f);  // 0 past nc
      __syncthreads();
      // the next step's partials: every reader has passed (a phase of 0 bytes completes at once)
      if (half == p && threadIdx.x == 0) mbar_expect(bar_part, part_bytes);
      DUAL_MARK(7);

      // ---- the rank's partial logits of every class, pushed to the class's owner ----
      const float* w2h = w2_s + (size_t)p * K * Ws;
      for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
        if (B - b0 == 1) push_share_logits<1>(w2h, f_s, lrecv_s, bar_logit, B, K, Kc, Cs, Ws, b0, rank);
        else push_share_logits<kBatchChunk>(w2h, f_s, lrecv_s, bar_logit, B, K, Kc, Cs, Ws, b0, rank);
      }
      DUAL_MARK(8);

      // ---- the rank's scores (the cluster's cs partial logits of its classes in rank
      // order) and its best (score, class) of each row, a warp to a row, pushed to
      // every rank of the cluster ----
      for (int b = warp; b < B; b += kWarps) {
        unsigned long long key = 0;  // below every (score, class)
        for (int kk = lane; kk < kn; kk += 32) {
          mbar_wait(bar_logit, (unsigned)p);
          const int q = b * Kc + kk;
          float s = lrecv_s[q];
#pragma unroll
          for (int r = 1; r < kMaxCluster; ++r)
            if (r < cs) s += lrecv_s[r * B * Kc + q];
          s += b2_s[p * Kc + kk];
          if (sampled) s = s / tdiv + noise_s[q];
          key = max(key, arg_key(s, k0 + kk));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
        if (lane < cs)
          push_key(remote(smem_addr(cand_s[p] + b * cs + rank), lane), key, remote(bar_cand[p], lane));
      }
      DUAL_MARK(9);

      // ---- while the candidates cross the cluster: each lane's Whh sums over the
      // half's columns of h_t, carried (coarse) or finished into gh (fine) ----
      if (warp < nu && t + 1 < T) {
        if (p == 0) gh_coarse(wreg, h_s, acc_s, B, H, warp, lane);
        else gh_fine(wreg, h_s, acc_s, bhh_s, gh_s, B, H, warp, lane);
      }
      __syncthreads();  // gh_s before the finishers; the buffers read before they are refilled
      if (threadIdx.x == 0) mbar_expect(bar_logit, logit_bytes);  // the next phase's: every reader has passed
      DUAL_MARK(10);
    }
  }

  // ---- the last sample; no block leaves while st.async data is still due to it ----
  mbar_wait(bar_cand[1], (T - 1) & 1);
  if (k == 0 && finisher && fu == 0)
    a.out[(size_t)fb * T + (T - 1)] = (cnow << 8) | key_index(best_candidate(cand_s[1] + fb * cs, cs));
  cluster.sync();
#ifdef WAVERNN_PROFILE
  if (kl == 0) {
    if (threadIdx.x < 2 * kDualMarks) g_prof_dual[half * 2 * kDualMarks + threadIdx.x] += prof_s[threadIdx.x];
    atomicAdd(&g_prof_dual[4 * kDualMarks + 2 * half], stale[0]);
    atomicAdd(&g_prof_dual[4 * kDualMarks + 2 * half + 1], stale[1]);
  }
#endif
}

// a check of the dual's split gh: unit blockIdx.x * kU + warp's gh for the B
// rows of h, by gate_dots (whole) and by gh_coarse then gh_fine (split),
// each (B, 3, H) in torch's gate order
__global__ void __launch_bounds__(kThreads) dual_gh_check_kernel(const float* whh, const float* bhh,
                                                                 const float* h, int B, int H,
                                                                 float* whole, float* split) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                       // B*H
  float* bhh_s = h_s + (size_t)B * H;      // 3U
  float* gh_s = bhh_s + 3 * kU;            // B*3U
  float* acc_s = gh_s + (size_t)B * 3 * kU;  // dual_acc_floats(B)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, j0 = blockIdx.x * kU;
  const int nu = max(0, min(kU, H - j0));
  for (int q = threadIdx.x; q < B * H; q += kThreads) h_s[q] = h[q];
  for (int q = threadIdx.x; q < 3 * kU; q += kThreads) {
    const int g = q / kU, u = q % kU;
    bhh_s[q] = u < nu ? bhh[g * H + j0 + u] : 0.f;
  }
  float4 wreg[3][kRegIters];
  if (warp < nu) load_whh(wreg, whh, H, j0 + warp, lane);
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    if (warp < nu) {
      if (pass == 0) {
        for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
          if (B - b0 == 1) gate_dots<1>(wreg, h_s, bhh_s, gh_s, B, H, H, b0, warp, lane);
          else gate_dots<kBatchChunk>(wreg, h_s, bhh_s, gh_s, B, H, H, b0, warp, lane);
        }
      } else {
        gh_coarse(wreg, h_s, acc_s, B, H, warp, lane);
        gh_fine(wreg, h_s, acc_s, bhh_s, gh_s, B, H, warp, lane);
      }
    }
    __syncthreads();
    float* out = pass == 0 ? whole : split;
    for (int q = threadIdx.x; q < B * 3 * kU; q += kThreads) {
      const int b = q / (3 * kU), g = q % (3 * kU) / kU, u = q % kU;
      if (u < nu) out[((size_t)b * 3 + g) * H + j0 + u] = gh_s[q];
    }
    __syncthreads();
  }
}

int plan_dual(int B, int H, int K, int* grid, int* units, int* cluster, int* stage_rows, int* smem) {
  if (B < 1 || H < 8 || H % 8 || K < 1 || H > 128 * kRegIters) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t e = device_facts(&sms, &optin);
  if (e != cudaSuccess) return e;
  const int U = kU, Hh = H / 2, Gh = (Hh + U - 1) / U;
  if ((long long)B * U > kThreads) return cudaErrorInvalidValue;
  // the largest cluster whose grid stays resident; a rank's values of a
  // phase are summed in one pass through shared memory
  for (int cs = kMaxCluster; cs >= 1; cs /= 2) {
    const int Ghp = (Gh + cs - 1) / cs * cs, NCh = Ghp / cs;
    const size_t s = dual_smem_layout(B, H, K, cs, NCh).total_bytes;
    if (s > (size_t)optin) continue;
    e = cudaFuncSetAttribute(wavernn_kernel_dual, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t c = launch_config(2 * Ghp, (int)s, attrs, cs, false, nullptr);
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, wavernn_kernel_dual, &c);
    if (e != cudaSuccess) return e;
    if (active < 2 * NCh) continue;
    *grid = 2 * Ghp;
    *units = U;
    *cluster = cs;
    *stage_rows = B * dual_share(Hh, cs);
    *smem = (int)s;
    return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;  // the heads' slices, the stage or the grid does not fit
}

}  // namespace

extern "C" {

// blocks (a multiple of the cluster size), units per block, cluster size,
// f-stage rows and dynamic shared bytes for one call
int wavernn_plan(int B, int H, int K, int FC, int* grid, int* units, int* cluster,
                 int* stage_rows, int* smem) {
  return plan(B, H, K, FC, grid, units, cluster, stage_rows, smem);
}

// xbuf: 2 * (grid / cluster * B * FCs + B * Hs) + 1 8-byte words, zeroed
// (a word holds a float and the step that wrote it); Hs and FCs being H and
// FC rounded up to multiples of 4
int wavernn_generate_f32(const void* gates, const void* emb, const void* whh, const void* bhh,
                         const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                         void* xbuf, unsigned seed, float temp, int B, int T, int H,
                         int K, int FC, int grid, int units, int cluster, int stage_rows, int smem,
                         void* stream) {
  if (B < 1 || T < 1 || H < 1 || K < 1 || FC < 1 || units != kU ||
      (long long)B * units > kThreads || (long long)B * up4(FC) > 4 * kThreads || H > 128 * kRegIters || stage_rows < 4 ||
      stage_rows % 4 || cluster < 1 || cluster > kMaxCluster || grid % cluster ||
      (long long)grid * units < H)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(gates),
         static_cast<const float*>(emb),
         static_cast<const float*>(whh),
         static_cast<const float*>(bhh),
         static_cast<const float*>(w1),
         static_cast<const float*>(b1),
         static_cast<const float*>(w2),
         static_cast<const float*>(b2),
         static_cast<int*>(out),
         static_cast<unsigned long long*>(xbuf),
         seed,
         temp,
         B, T, H, K, FC, cluster,
         (int)up4(H), (int)up4(FC), (int)up4((K + cluster - 1) / cluster),
         stage_rows};
  cudaError_t e = cudaFuncSetAttribute(wavernn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t c =
      launch_config(grid, smem, attrs, cluster, true, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&c, wavernn_kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the dual instantiation's plan (fc unused) and launch; xbuf: 4 * (grid / 2 *
// B * Cs + B * H/2) 8-byte words, zeroed, Cs = H/2 / cluster rounded up to a
// multiple of 4
int wavernn_dual_plan(int B, int H, int K, int /*fc*/, int* grid, int* units, int* cluster,
                      int* stage_rows, int* smem) {
  return plan_dual(B, H, K, grid, units, cluster, stage_rows, smem);
}

int wavernn_dual_generate_f32(const void* gates, const void* win, const void* whh, const void* bhh,
                              const void* o1, const void* b1, const void* o2, const void* b2,
                              const void* o3, const void* b3, const void* o4, const void* b4,
                              void* out, void* xbuf, unsigned seed, float temp, int B, int T, int H,
                              int K, int grid, int units, int cluster, int smem, void* stream) {
  if (B < 1 || T < 1 || H < 8 || H % 8 || K < 1 || units != kU || (long long)B * units > kThreads ||
      H > 128 * kRegIters || cluster < 1 || cluster > kMaxCluster || grid % (2 * cluster) ||
      (long long)grid / 2 * units < H / 2)
    return cudaErrorInvalidValue;
  DualArgs a{static_cast<const float*>(gates), static_cast<const float*>(win),
             static_cast<const float*>(whh),   static_cast<const float*>(bhh),
             static_cast<const float*>(o1),    static_cast<const float*>(b1),
             static_cast<const float*>(o2),    static_cast<const float*>(b2),
             static_cast<const float*>(o3),    static_cast<const float*>(b3),
             static_cast<const float*>(o4),    static_cast<const float*>(b4),
             static_cast<int*>(out),           static_cast<unsigned long long*>(xbuf),
             seed,
             temp,
             B, T, H, K, cluster,
             grid / 2,
             (int)up4((K + cluster - 1) / cluster)};
  cudaError_t e = cudaFuncSetAttribute(wavernn_kernel_dual, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t c =
      launch_config(grid, smem, attrs, cluster, true, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&c, wavernn_kernel_dual, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the dual's gh, whole and split (dual_gh_check_kernel), for a test on the card
int wavernn_dual_gh_check(const void* whh, const void* bhh, const void* h, int B, int H, void* whole,
                          void* split, void* stream) {
  if (B < 1 || H < 8 || H % 8 || H > 128 * kRegIters) return cudaErrorInvalidValue;
  const int smem = (int)(((size_t)B * H + 3 * kU + (size_t)B * 3 * kU + dual_acc_floats(B)) * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(dual_gh_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dual_gh_check_kernel<<<(H + kU - 1) / kU, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(whh), static_cast<const float*>(bhh), static_cast<const float*>(h), B, H,
      static_cast<float*>(whole), static_cast<float*>(split));
  return cudaGetLastError();
}

#ifdef WAVERNN_PROFILE
int wavernn_profile_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[kPhases] = {};
  return cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}

// the dual's: [half][phase][mark] cycles, then [half][phase] stale poll passes; zeroed after
int wavernn_profile_read_dual(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof_dual, sizeof(g_prof_dual));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[sizeof(g_prof_dual) / sizeof(g_prof_dual[0])] = {};
  return cudaMemcpyToSymbol(g_prof_dual, zero, sizeof(g_prof_dual));
}
#endif

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
