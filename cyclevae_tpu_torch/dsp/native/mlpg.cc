// MLPG: banded-Cholesky maximum-likelihood parameter generation.  See mlpg.h.

#include "mlpg.h"

#include <algorithm>
#include <cmath>

namespace cvdsp {

namespace {

// Banded SPD solve via Cholesky.  R is stored as (T, L+1): R_band[t][j]
// holds R[t][t+j] for j in [0, L] (upper band, symmetric).  Solves
// R x = r in place: r becomes x.  O(T * L^2).  Returns 0 on success, -1 if
// a pivot degenerates (a frame unobserved by every window makes the normal
// matrix singular — fail loudly instead of emitting garbage trajectories).
int band_cholesky_solve(std::vector<double>& R_band, std::vector<double>& r,
                        int T, int L, double diag_scale) {
  const int W = L + 1;
  // degenerate-pivot threshold relative to the matrix magnitude
  const double pivot_min = diag_scale * 1e-12;
  // factor: R = U' U with U upper-banded, stored back into R_band
  for (int t = 0; t < T; ++t) {
    double d = R_band[t * W];
    const int kmin = std::max(0, t - L);
    for (int k = kmin; k < t; ++k) {
      const double u = R_band[k * W + (t - k)];
      d -= u * u;
    }
    if (!(d > pivot_min)) return -1;
    d = std::sqrt(d);
    R_band[t * W] = d;
    const int jmax = std::min(L, T - 1 - t);
    for (int j = 1; j <= jmax; ++j) {
      double s = R_band[t * W + j];
      const int kmin2 = std::max({0, t - L, t + j - L});
      for (int k = kmin2; k < t; ++k)
        s -= R_band[k * W + (t - k)] * R_band[k * W + (t + j - k)];
      R_band[t * W + j] = s / d;
    }
  }
  // forward solve U' y = r
  for (int t = 0; t < T; ++t) {
    double s = r[t];
    const int kmin = std::max(0, t - L);
    for (int k = kmin; k < t; ++k) s -= R_band[k * W + (t - k)] * r[k];
    r[t] = s / R_band[t * W];
  }
  // back solve U x = y
  for (int t = T - 1; t >= 0; --t) {
    double s = r[t];
    const int jmax = std::min(L, T - 1 - t);
    for (int j = 1; j <= jmax; ++j) s -= R_band[t * W + j] * r[t + j];
    r[t] = s / R_band[t * W];
  }
  return 0;
}

}  // namespace

int mlpg_solve(const double* mean, const double* var, int T, int dim,
               const double* windows, const int* win_lens, int n_win,
               double* out) {
  // normal-equation band half-width: rows of W'PW couple columns t+o1 and
  // t+o2 for taps o1, o2 in [-l, l], so offsets reach 2l = win_len - 1
  int L = 0;
  for (int k = 0; k < n_win; ++k) L = std::max(L, win_lens[k] - 1);
  const int W = L + 1;
  const int stride = n_win * dim;

  std::vector<double> R_band((size_t)T * W);
  std::vector<double> r(T);

  for (int d = 0; d < dim; ++d) {
    std::fill(R_band.begin(), R_band.end(), 0.0);
    std::fill(r.begin(), r.end(), 0.0);

    // accumulate W' P W (upper band) and W' P mu.  Row (t, k) of W has taps
    // w[o] at columns t+o, o in [-l, l]; taps falling outside [0, T) are
    // dropped (zero-padded window truncation at the edges).
    const double* wptr = windows;
    for (int k = 0; k < n_win; ++k) {
      const int len = win_lens[k];
      const int l = (len - 1) / 2;
      for (int t = 0; t < T; ++t) {
        const double v = var[(size_t)t * stride + k * dim + d];
        if (!(v > 0.0)) continue;  // zero/neg variance = unobserved row
        const double p = 1.0 / v;
        const double mu = mean[(size_t)t * stride + k * dim + d];
        for (int o1 = -l; o1 <= l; ++o1) {
          const int c1 = t + o1;
          if (c1 < 0 || c1 >= T) continue;
          const double w1 = wptr[o1 + l];
          if (w1 == 0.0) continue;
          r[c1] += w1 * p * mu;
          for (int o2 = o1; o2 <= l; ++o2) {
            const int c2 = t + o2;
            if (c2 < 0 || c2 >= T) continue;
            const double w2 = wptr[o2 + l];
            if (w2 == 0.0) continue;
            R_band[(size_t)c1 * W + (c2 - c1)] += w1 * p * w2;
          }
        }
      }
      wptr += len;
    }

    // matrix magnitude for the relative degenerate-pivot test
    double diag_max = 0.0;
    for (int t = 0; t < T; ++t)
      diag_max = std::max(diag_max, R_band[(size_t)t * W]);
    if (diag_max == 0.0) return -1;  // every frame unobserved in column d

    if (band_cholesky_solve(R_band, r, T, L, diag_max) != 0) return -1;
    for (int t = 0; t < T; ++t) out[(size_t)t * dim + d] = r[t];
  }
  return 0;
}

}  // namespace cvdsp
