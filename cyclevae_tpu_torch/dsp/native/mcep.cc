#include "mcep.h"

#include <cmath>
#include <cstring>

#include "fft.h"

namespace cvdsp {

std::vector<double> freqt(const std::vector<double>& c, int m2, double alpha) {
  // Oppenheim frequency-warping recursion (one-sided cepstrum).
  const int m1 = (int)c.size() - 1;
  const double b = 1.0 - alpha * alpha;
  std::vector<double> g(m2 + 1, 0.0), d(m2 + 1, 0.0);
  for (int i = -m1; i <= 0; ++i) {
    const double x = c[-i];
    if (m2 >= 0) {
      d[0] = g[0];
      g[0] = x + alpha * d[0];
    }
    if (m2 >= 1) {
      d[1] = g[1];
      g[1] = b * d[0] + alpha * d[1];
    }
    for (int j = 2; j <= m2; ++j) {
      d[j] = g[j];
      g[j] = d[j - 1] + alpha * (d[j] - g[j - 1]);
    }
  }
  return g;
}

std::vector<double> sp2mc(const std::vector<double>& powerspec, int order,
                          double alpha, int fftl) {
  // log power spectrum -> real cepstrum -> warped (mel) cepstrum.
  const int half = fftl / 2;
  std::vector<cplx> logsp(half + 1);
  for (int i = 0; i <= half; ++i)
    logsp[i] = cplx(std::log(std::max(powerspec[i], 1e-300)), 0.0);
  std::vector<double> c = irfft(logsp, fftl);
  c[0] /= 2.0;
  c.resize(half + 1);
  return freqt(c, order, alpha);
}

std::vector<double> mc2sp(const std::vector<double>& mc, double alpha, int fftl) {
  const int half = fftl / 2;
  std::vector<double> c = freqt(mc, half, -alpha);
  // symmetric cepstrum -> rfft -> exp
  std::vector<double> sym(fftl, 0.0);
  sym[0] = 2.0 * c[0];
  for (int i = 1; i <= half; ++i) {
    sym[i] = c[i];
    if (i < half) sym[fftl - i] = c[i];
  }
  std::vector<cplx> spec = rfft(sym);
  std::vector<double> ps(half + 1);
  for (int i = 0; i <= half; ++i) ps[i] = std::exp(spec[i].real());
  return ps;
}

double mc2e(const std::vector<double>& mc, double alpha, int irlen) {
  // Energy of the (irlen-truncated) impulse response of exp(C(z)), computed
  // in the frequency domain: C(omega) on a 2*irlen grid from the zero-padded
  // unwarped cepstrum, h = irfft(exp(C)), energy = sum_{n<irlen} h^2.
  // Equal to the O(irlen^2) c2ir recursion up to circular aliasing of the
  // IR tail beyond 2*irlen (negligible for stable spectral envelopes, and
  // verified against the direct recursion in tests/test_dsp.py); ~8x less
  // work per frame — this is the stage-6 mod_pow hot path.
  std::vector<double> c = freqt(mc, irlen - 1, -alpha);
  const size_t N = 2 * (size_t)irlen;
  std::vector<double> cpad(N, 0.0);
  std::memcpy(cpad.data(), c.data(), c.size() * sizeof(double));
  std::vector<cplx> C = rfft(cpad);
  for (size_t i = 0; i < C.size(); ++i) C[i] = std::exp(C[i]);
  std::vector<double> h = irfft(C, N);
  double e = 0.0;
  for (int n = 0; n < irlen; ++n) e += h[n] * h[n];
  return e;
}

double mc2e_direct(const std::vector<double>& mc, double alpha, int irlen) {
  // Reference O(irlen^2) path (unwarp, c2ir recursion, sum of squares) —
  // kept as the oracle for the FFT fast path above.
  std::vector<double> c = freqt(mc, irlen - 1, -alpha);
  std::vector<double> h(irlen, 0.0);
  h[0] = std::exp(c[0]);
  const int m = (int)c.size() - 1;
  for (int n = 1; n < irlen; ++n) {
    double acc = 0.0;
    const int upper = n < m ? n : m;
    for (int k = 1; k <= upper; ++k)
      acc += ((double)k / (double)n) * c[k] * h[n - k];
    h[n] = acc;
  }
  double e = 0.0;
  for (int n = 0; n < irlen; ++n) e += h[n] * h[n];
  return e;
}

std::vector<double> mc2b(const std::vector<double>& mc, double alpha) {
  const int m = (int)mc.size() - 1;
  std::vector<double> b(m + 1);
  b[m] = mc[m];
  for (int k = m - 1; k >= 0; --k) b[k] = mc[k] - alpha * b[k + 1];
  return b;
}

std::vector<double> b2mc(const std::vector<double>& b, double alpha) {
  const int m = (int)b.size() - 1;
  std::vector<double> c(m + 1);
  c[m] = b[m];
  for (int k = m - 1; k >= 0; --k) c[k] = b[k] + alpha * b[k + 1];
  return c;
}

// ---------------------------------------------------------------------------
// MLSA digital filter, Pade order 5.
//
// H(z) = exp( sum_k b[k] Phi_k(z) ),  Phi_0 = 1,
//   Phi_1(z) = (1-a^2) z^-1 / (1 - a z^-1),
//   Phi_k(z) = Phi_1(z) * Atilde(z)^(k-1),  Atilde(z) = (z^-1 - a)/(1 - a z^-1).
// Realized as exp(b0) * F1 * F2 with F1 = exp(b1 Phi_1),
// F2 = exp(sum_{k>=2} b_k Phi_k); each exponential approximated by the
// standard Pade(5) feedback structure: with basic filter B,
//   u_i[n] = B(u_{i-1})[n] (each tap has its own B state; u_0 = previous
//   feedback output), y = x + sum_i (+/-) pade_i u_i (feedback),
//   out = y + sum_i pade_i u_i.
// ---------------------------------------------------------------------------

static const double kPade5[6] = {1.0,           0.4999391,     0.1107098,
                                 0.01369984,    0.0005685586,  0.00001834409};
static const int kPd = 5;

// NOTE on delays: the Pade tap loop runs in DESCENDING order, so the `u`
// passed to each stage is the upstream tap's value from the PREVIOUS sample —
// it already carries the z^-1 of Phi_1.  The stages therefore use `u`
// directly (adding another internal delay here would square the z^-1 and
// distort the realized spectrum).

double Stage1Basic::step(double u, double b1, double alpha) {
  const double e1_new = (1.0 - alpha * alpha) * u + alpha * e1;
  e1 = e1_new;
  x_prev = u;
  return b1 * e1_new;
}

double Stage2Basic::step(double u, const std::vector<double>& b, double alpha) {
  const int m = (int)b.size() - 1;
  const double aa = 1.0 - alpha * alpha;
  // with u = input[n-1]:  e_1[n] = aa * u + a * e_1[n-1]
  // e_k[n] = e_{k-1}[n-1] - a * e_{k-1}[n] + a * e_k[n-1]   (Atilde chain)
  std::vector<double> en(m + 1, 0.0);
  en[1] = aa * u + alpha * e[1];
  double y = 0.0;
  for (int k = 2; k <= m; ++k) {
    en[k] = e[k - 1] - alpha * en[k - 1] + alpha * e[k];
    y += b[k] * en[k];
  }
  e.swap(en);
  x_prev = u;
  return y;
}

MLSADF::MLSADF(int order, double alpha) : order_(order), alpha_(alpha) {
  pd1_.assign(kPd + 1, 0.0);
  pd2_.assign(kPd + 1, 0.0);
  state1_.resize(kPd + 1);
  state2_.resize(kPd + 1);
  for (auto& s : state2_) s.init(order_);
}

double MLSADF::filter_stage1(double x, const std::vector<double>& b) {
  double out = 0.0;
  double acc = x;
  for (int i = kPd; i >= 1; --i) {
    // tap i consumes the previous sample's tap i-1 output
    const double u = state1_[i].step(pd1_[i - 1], b[1], alpha_);
    pd1_[i] = u;
    const double v = kPade5[i] * u;
    acc += (i & 1) ? v : -v;
    out += v;
  }
  pd1_[0] = acc;
  out += acc;
  return out;
}

double MLSADF::filter_stage2(double x, const std::vector<double>& b) {
  double out = 0.0;
  double acc = x;
  for (int i = kPd; i >= 1; --i) {
    const double u = state2_[i].step(pd2_[i - 1], b, alpha_);
    pd2_[i] = u;
    const double v = kPade5[i] * u;
    acc += (i & 1) ? v : -v;
    out += v;
  }
  pd2_[0] = acc;
  out += acc;
  return out;
}

double MLSADF::filter(double x, const std::vector<double>& b) {
  const double y1 = filter_stage1(x, b);
  const double y2 = filter_stage2(y1, b);
  return y2 * std::exp(b[0]);
}

}  // namespace cvdsp
