// Dynamic time warping + mel-cepstral distortion kernels.
//
// Capability parity with the reference's dtw_c Cython extension:
//   dtw_org_to_trg(org, trg [, mcd]) -> (aligned_org, twf, mean_mcd, per-frame)
//     call sites: train…py:679-688, decode…py:334-364, calc_cvgv…py:210-277
//   calc_mcd(x, y) -> (mean_mcd, per-frame mcd)
//     call sites: train…py:932-948, 1435-1439
// Clean-room implementation: standard symmetric DP with (i-1,j), (i,j-1),
// (i-1,j-1) steps over an MCD local distance, producing one matched org frame
// per trg frame (time-warping function twf).
#pragma once

#include <cstddef>
#include <vector>

namespace cvdsp {

// Per-frame MCD in dB between two equal-dim frames.
double frame_mcd(const double* x, const double* y, int dim);

// Frame-wise MCD over equal-length sequences (no alignment).
// x, y: row-major (T, dim). out_perframe must hold T doubles.
double calc_mcd(const double* x, const double* y, int T, int dim,
                double* out_perframe);

// DTW-align org (T_org, dim) to trg (T_trg, dim).
// Writes twf: T_trg org-frame indices (monotone), per-frame MCD between
// aligned org and trg, and returns the mean MCD over trg frames.
double dtw_org_to_trg(const double* org, int T_org, const double* trg,
                      int T_trg, int dim, int* out_twf, double* out_perframe);

}  // namespace cvdsp
