// Maximum-likelihood parameter generation (MLPG).
//
// Closes the last native-inventory row: the reference pins `mlpg_c`
// (reference tools/requirements.txt:10) but never imports it — this is a
// from-scratch implementation of the algorithm that package provides
// (Tokuda et al. 2000 "Speech parameter generation algorithms for HMM-based
// speech synthesis"), not a translation of it.
//
// Given per-frame means and diagonal variances of windowed features
// (static + delta [+ delta-delta]), solve for the static trajectory c that
// maximizes the Gaussian likelihood:  (W' P W) c = W' P mu,  with W the
// stacked window matrix and P = diag(1/var).  The normal equations are a
// symmetric positive-definite band system (bandwidth = max window half-
// width), solved per dimension by banded Cholesky — O(T * L^2) per dim.
#ifndef CVDSP_MLPG_H_
#define CVDSP_MLPG_H_

#include <vector>

namespace cvdsp {

// mean/var: (T, n_win * dim) row-major, window-major within a frame
// (columns [k*dim, (k+1)*dim) hold window k's statistics — the layout the
// HTS/mlpg_c tools use).  windows: concatenated odd-length window taps;
// win_lens[k] = taps of window k (center tap applies to frame t).
// out: (T, dim) static trajectory.  Returns 0 on success, -1 if the normal
// matrix is singular (some frame unobserved by every window).
int mlpg_solve(const double* mean, const double* var, int T, int dim,
                const double* windows, const int* win_lens, int n_win,
                double* out);

}  // namespace cvdsp

#endif  // CVDSP_MLPG_H_
