// SPTK-class mel-cepstrum operations (clean-room implementations).
//
// Capability parity targets (reference call sites):
//   sp2mc / mc2sp : feature_extract_vc.py:354-355,400; decode…py:259,272,480-520
//   mc2e          : mod_pow power correction, feature_extract_vc.py:131-138
//   mc2b + MLSA   : differential-spectrum waveform filtering, decode…py:529-533
#pragma once

#include <cstddef>
#include <vector>

namespace cvdsp {

// Frequency transform (Oppenheim recursion): cepstrum c (m1+1 coeffs) ->
// warped cepstrum (m2+1 coeffs) with all-pass parameter alpha.
std::vector<double> freqt(const std::vector<double>& c, int m2, double alpha);

// Power spectrum (fftl/2+1 bins) -> mel-cepstrum (order+1 coeffs).
std::vector<double> sp2mc(const std::vector<double>& powerspec, int order,
                          double alpha, int fftl);

// Mel-cepstrum -> power spectrum (fftl/2+1 bins).
std::vector<double> mc2sp(const std::vector<double>& mc, double alpha, int fftl);

// Mel-cepstrum -> frame energy via truncated impulse response (irlen taps).
double mc2e(const std::vector<double>& mc, double alpha, int irlen);
double mc2e_direct(const std::vector<double>& mc, double alpha, int irlen);

// Mel-cepstrum -> MLSA filter coefficients b (in place convention of SPTK mc2b).
std::vector<double> mc2b(const std::vector<double>& mc, double alpha);
std::vector<double> b2mc(const std::vector<double>& b, double alpha);

// Basic filter for MLSA stage 1: v = b1 * Phi_1(u).  State: one allpass pole.
struct Stage1Basic {
  double e1 = 0.0;
  double x_prev = 0.0;
  double step(double u, double b1, double alpha);
};

// Basic filter for MLSA stage 2: v = sum_{k=2..m} b[k] e_k(u), allpass chain.
struct Stage2Basic {
  std::vector<double> e;
  double x_prev = 0.0;
  void init(int m) { e.assign(m + 1, 0.0); }
  double step(double u, const std::vector<double>& b, double alpha);
};

// MLSA digital filter (Pade order 5) streaming state.
class MLSADF {
 public:
  MLSADF(int order, double alpha);
  // Filter one sample with coefficients b (order+1).
  double filter(double x, const std::vector<double>& b);

 private:
  double filter_stage1(double x, const std::vector<double>& b);
  double filter_stage2(double x, const std::vector<double>& b);
  int order_;
  double alpha_;
  std::vector<Stage1Basic> state1_;
  std::vector<Stage2Basic> state2_;
  std::vector<double> pd1_;  // pade feedback taps stage 1
  std::vector<double> pd2_;  // pade feedback taps stage 2
};

}  // namespace cvdsp
