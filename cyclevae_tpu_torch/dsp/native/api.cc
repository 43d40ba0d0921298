// extern "C" API for ctypes binding (cyclevae_tpu.dsp._lib).
// All arrays are row-major float64; callers pre-allocate outputs using the
// deterministic size helpers below.

#include <cstdint>
#include <cstring>
#include <vector>

#include "dtw.h"
#include "mcep.h"
#include "mlpg.h"
#include "pitch.h"
#include "vocoder.h"

using namespace cvdsp;

extern "C" {

// ---------------- pitch ----------------

int cvdsp_n_frames(int n, int fs, double frame_period) {
  return (int)(n / (fs * frame_period / 1000.0)) + 1;
}

void cvdsp_estimate_f0(const double* x, int n, int fs, double frame_period,
                       double f0_floor, double f0_ceil, double* out_f0,
                       double* out_time) {
  auto res = estimate_f0(x, n, fs, frame_period, f0_floor, f0_ceil);
  std::memcpy(out_f0, res.f0.data(), res.f0.size() * sizeof(double));
  std::memcpy(out_time, res.time_axis.data(),
              res.time_axis.size() * sizeof(double));
}

void cvdsp_refine_f0(const double* x, int n, int fs, const double* time_axis,
                     const double* f0, int n_frames, double* out) {
  std::vector<double> ta(time_axis, time_axis + n_frames);
  std::vector<double> f(f0, f0 + n_frames);
  auto r = refine_f0(x, n, fs, ta, f);
  std::memcpy(out, r.data(), r.size() * sizeof(double));
}

// ---------------- envelope / aperiodicity / synthesis ----------------

void cvdsp_spectral_envelope(const double* x, int n, int fs,
                             const double* time_axis, const double* f0,
                             int n_frames, int fftl, double* out) {
  std::vector<double> ta(time_axis, time_axis + n_frames);
  std::vector<double> f(f0, f0 + n_frames);
  auto r = spectral_envelope(x, n, fs, ta, f, fftl);
  std::memcpy(out, r.data(), r.size() * sizeof(double));
}

void cvdsp_aperiodicity(const double* x, int n, int fs,
                        const double* time_axis, const double* f0,
                        int n_frames, int fftl, double* out) {
  std::vector<double> ta(time_axis, time_axis + n_frames);
  std::vector<double> f(f0, f0 + n_frames);
  auto r = aperiodicity(x, n, fs, ta, f, fftl);
  std::memcpy(out, r.data(), r.size() * sizeof(double));
}

int cvdsp_n_coded_aperiodicity(int fs) { return n_coded_aperiodicity(fs); }

void cvdsp_code_aperiodicity(const double* ap, int n_frames, int fs, int fftl,
                             double* out) {
  std::vector<double> a(ap, ap + (size_t)n_frames * (fftl / 2 + 1));
  auto r = code_aperiodicity(a, n_frames, fs, fftl);
  std::memcpy(out, r.data(), r.size() * sizeof(double));
}

void cvdsp_decode_aperiodicity(const double* coded, int n_frames, int fs,
                               int fftl, double* out) {
  std::vector<double> c(coded,
                        coded + (size_t)n_frames * n_coded_aperiodicity(fs));
  auto r = decode_aperiodicity(c, n_frames, fs, fftl);
  std::memcpy(out, r.data(), r.size() * sizeof(double));
}

int cvdsp_synthesis_length(int n_frames, int fs, double frame_period) {
  const int hop = (int)(frame_period / 1000.0 * fs + 0.5);
  return (n_frames - 1) * hop + hop;
}

void cvdsp_synthesize(const double* f0, const double* sp, const double* ap,
                      int n_frames, int fs, double frame_period, int fftl,
                      uint64_t seed, double* out) {
  std::vector<double> f(f0, f0 + n_frames);
  std::vector<double> s(sp, sp + (size_t)n_frames * (fftl / 2 + 1));
  std::vector<double> a(ap, ap + (size_t)n_frames * (fftl / 2 + 1));
  auto y = synthesize(f, s, a, n_frames, fs, frame_period, fftl, seed);
  const int want = cvdsp_synthesis_length(n_frames, fs, frame_period);
  y.resize(want, 0.0);
  std::memcpy(out, y.data(), (size_t)want * sizeof(double));
}

// ---------------- mel-cepstrum ----------------

void cvdsp_sp2mc(const double* ps, int n_frames, int order, double alpha,
                 int fftl, double* out) {
  const int half = fftl / 2;
  for (int t = 0; t < n_frames; ++t) {
    std::vector<double> row(ps + (size_t)t * (half + 1),
                            ps + (size_t)(t + 1) * (half + 1));
    auto mc = sp2mc(row, order, alpha, fftl);
    std::memcpy(out + (size_t)t * (order + 1), mc.data(),
                (order + 1) * sizeof(double));
  }
}

void cvdsp_mc2sp(const double* mc, int n_frames, int order, double alpha,
                 int fftl, double* out) {
  const int half = fftl / 2;
  for (int t = 0; t < n_frames; ++t) {
    std::vector<double> row(mc + (size_t)t * (order + 1),
                            mc + (size_t)(t + 1) * (order + 1));
    auto ps = mc2sp(row, alpha, fftl);
    std::memcpy(out + (size_t)t * (half + 1), ps.data(),
                (half + 1) * sizeof(double));
  }
}

void cvdsp_freqt(const double* c, int m1, int m2, double alpha, double* out) {
  std::vector<double> cin(c, c + m1 + 1);
  auto r = freqt(cin, m2, alpha);
  std::memcpy(out, r.data(), (m2 + 1) * sizeof(double));
}

void cvdsp_mc2e(const double* mc, int n_frames, int order, double alpha,
                int irlen, double* out) {
  for (int t = 0; t < n_frames; ++t) {
    std::vector<double> row(mc + (size_t)t * (order + 1),
                            mc + (size_t)(t + 1) * (order + 1));
    out[t] = mc2e(row, alpha, irlen);
  }
}

void cvdsp_mc2e_direct(const double* mc, int n_frames, int order, double alpha,
                       int irlen, double* out) {
  // O(irlen^2) oracle for the FFT fast path (tests only)
  for (int t = 0; t < n_frames; ++t) {
    std::vector<double> row(mc + (size_t)t * (order + 1),
                            mc + (size_t)(t + 1) * (order + 1));
    out[t] = mc2e_direct(row, alpha, irlen);
  }
}

void cvdsp_mc2b(const double* mc, int n_frames, int order, double alpha,
                double* out) {
  for (int t = 0; t < n_frames; ++t) {
    std::vector<double> row(mc + (size_t)t * (order + 1),
                            mc + (size_t)(t + 1) * (order + 1));
    auto b = mc2b(row, alpha);
    std::memcpy(out + (size_t)t * (order + 1), b.data(),
                (order + 1) * sizeof(double));
  }
}

void cvdsp_b2mc(const double* b, int n_frames, int order, double alpha,
                double* out) {
  for (int t = 0; t < n_frames; ++t) {
    std::vector<double> row(b + (size_t)t * (order + 1),
                            b + (size_t)(t + 1) * (order + 1));
    auto mc = b2mc(row, alpha);
    std::memcpy(out + (size_t)t * (order + 1), mc.data(),
                (order + 1) * sizeof(double));
  }
}

// MLSA-filter a waveform with per-frame coefficients b (n_frames, order+1),
// advancing coefficients every `hop` samples (pysptk Synthesizer semantics).
void cvdsp_mlsadf(const double* x, int n, const double* b, int n_frames,
                  int order, double alpha, int hop, double* out) {
  MLSADF filt(order, alpha);
  std::vector<double> coef(order + 1);
  for (int i = 0; i < n; ++i) {
    int fr = hop > 0 ? i / hop : 0;
    if (fr > n_frames - 1) fr = n_frames - 1;
    std::memcpy(coef.data(), b + (size_t)fr * (order + 1),
                (order + 1) * sizeof(double));
    out[i] = filt.filter(x[i], coef);
  }
}

// ---------------- MLPG ----------------

// mean/var: (T, n_win*dim) window-major; windows: concatenated odd-length
// taps with lengths win_lens; out: (T, dim).  See mlpg.h.
int cvdsp_mlpg(const double* mean, const double* var, int T, int dim,
               const double* windows, const int32_t* win_lens, int n_win,
               double* out) {
  std::vector<int> lens(win_lens, win_lens + n_win);
  return mlpg_solve(mean, var, T, dim, windows, lens.data(), n_win, out);
}

// ---------------- DTW / MCD ----------------

double cvdsp_calc_mcd(const double* x, const double* y, int T, int dim,
                      double* out_perframe) {
  return calc_mcd(x, y, T, dim, out_perframe);
}

double cvdsp_dtw_org_to_trg(const double* org, int T_org, const double* trg,
                            int T_trg, int dim, int32_t* out_twf,
                            double* out_perframe) {
  std::vector<int> twf(T_trg);
  const double mean =
      dtw_org_to_trg(org, T_org, trg, T_trg, dim, twf.data(), out_perframe);
  for (int t = 0; t < T_trg; ++t) out_twf[t] = twf[t];
  return mean;
}

}  // extern "C"
