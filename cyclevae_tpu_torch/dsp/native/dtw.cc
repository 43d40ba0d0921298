#include "dtw.h"

#include <cmath>
#include <limits>

namespace cvdsp {

static const double kMcdK = 10.0 / 2.3025850929940456840179914546844;

double frame_mcd(const double* x, const double* y, int dim) {
  double s = 0.0;
  for (int d = 0; d < dim; ++d) {
    const double diff = x[d] - y[d];
    s += diff * diff;
  }
  return kMcdK * std::sqrt(2.0 * s);
}

double calc_mcd(const double* x, const double* y, int T, int dim,
                double* out_perframe) {
  double mean = 0.0;
  for (int t = 0; t < T; ++t) {
    const double m = frame_mcd(x + (size_t)t * dim, y + (size_t)t * dim, dim);
    out_perframe[t] = m;
    mean += m;
  }
  return T > 0 ? mean / T : 0.0;
}

double dtw_org_to_trg(const double* org, int T_org, const double* trg,
                      int T_trg, int dim, int* out_twf, double* out_perframe) {
  const double INF = std::numeric_limits<double>::infinity();
  // local distance matrix implicit; DP row by row over org index i, trg index j
  std::vector<double> prev(T_trg, INF), cur(T_trg, INF);
  // backpointers: 0 = diag, 1 = left (j-1, same i), 2 = up (i-1, same j)
  std::vector<unsigned char> bp((size_t)T_org * T_trg);

  for (int i = 0; i < T_org; ++i) {
    const double* oi = org + (size_t)i * dim;
    for (int j = 0; j < T_trg; ++j) {
      const double d = frame_mcd(oi, trg + (size_t)j * dim, dim);
      double best;
      unsigned char b;
      if (i == 0 && j == 0) {
        best = 0.0;
        b = 0;
      } else {
        const double diag = (i > 0 && j > 0) ? prev[j - 1] : INF;
        const double left = (j > 0) ? cur[j - 1] : INF;
        const double up = (i > 0) ? prev[j] : INF;
        best = diag; b = 0;
        if (left < best) { best = left; b = 1; }
        if (up < best) { best = up; b = 2; }
      }
      cur[j] = best + d;
      bp[(size_t)i * T_trg + j] = b;
    }
    prev.swap(cur);
  }

  // backtrack from (T_org-1, T_trg-1); record one org index per trg frame
  // (the last org frame visited at each trg column on the optimal path)
  int i = T_org - 1, j = T_trg - 1;
  std::vector<int> twf(T_trg, -1);
  while (true) {
    if (twf[j] < 0) twf[j] = i;
    if (i == 0 && j == 0) break;
    const unsigned char b = bp[(size_t)i * T_trg + j];
    if (b == 0) { --i; --j; }
    else if (b == 1) { --j; }
    else { --i; }
    if (i < 0) i = 0;
    if (j < 0) j = 0;
  }
  for (int t = 0; t < T_trg; ++t) {
    if (twf[t] < 0) twf[t] = t > 0 ? twf[t - 1] : 0;
    out_twf[t] = twf[t];
  }
  double mean = 0.0;
  for (int t = 0; t < T_trg; ++t) {
    const double m =
        frame_mcd(org + (size_t)twf[t] * dim, trg + (size_t)t * dim, dim);
    out_perframe[t] = m;
    mean += m;
  }
  return T_trg > 0 ? mean / T_trg : 0.0;
}

}  // namespace cvdsp
