// Spectral envelope, band aperiodicity, and synthesis
// (WORLD cheaptrick/d4c/synthesize capability class; clean-room design).
//
// Conventions:
//  * Spectra are one-sided power spectra with fftl/2+1 bins, normalized by the
//    analysis window energy (sum w^2) so that an impulse train of amplitude
//    sqrt(period_samples) through envelope H reproduces |H|^2 — this makes
//    analysis->synthesis self-consistent (gain calibration note in
//    synthesis.cc).
//  * Aperiodicity is per-bin in [0, 1); band coding samples it at 3 kHz
//    intervals (2 coded bands at fs 22.05k, matching the reference feature
//    layout feature_extract_vc.py:352-353 → 2-dim codeap).
#pragma once

#include <cstdint>
#include <vector>

namespace cvdsp {

// Pitch-adaptive spectral envelope per frame.
// f0[t] == 0 (unvoiced) uses default_f0 for the adaptive window.
// Returns row-major (n_frames, fftl/2+1) power spectra.
std::vector<double> spectral_envelope(const double* x, int n, int fs,
                                      const std::vector<double>& time_axis,
                                      const std::vector<double>& f0, int fftl,
                                      double default_f0 = 500.0);

// Band aperiodicity per frame: (n_frames, fftl/2+1) in [0.001, 0.999].
std::vector<double> aperiodicity(const double* x, int n, int fs,
                                 const std::vector<double>& time_axis,
                                 const std::vector<double>& f0, int fftl);

// Number of coded aperiodicity bands for a sample rate (3 kHz spacing).
int n_coded_aperiodicity(int fs);

// Code/decode aperiodicity: coded value = 20*log10(ap) sampled at 3k*(i+1) Hz.
std::vector<double> code_aperiodicity(const std::vector<double>& ap,
                                      int n_frames, int fs, int fftl);
std::vector<double> decode_aperiodicity(const std::vector<double>& coded,
                                        int n_frames, int fs, int fftl);

// Overlap-add pitch-synchronous synthesis.
// sp, ap: row-major (n_frames, fftl/2+1); frame_period ms.
std::vector<double> synthesize(const std::vector<double>& f0,
                               const std::vector<double>& sp,
                               const std::vector<double>& ap, int n_frames,
                               int fs, double frame_period, int fftl,
                               uint64_t seed = 1234567);

}  // namespace cvdsp
