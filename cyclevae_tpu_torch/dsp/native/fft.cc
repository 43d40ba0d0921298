#include "fft.h"

namespace cvdsp {

void fft_inplace(std::vector<cplx>& a, bool inverse) {
  const size_t n = a.size();
  if (n <= 1) return;
  // bit reversal
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = 2.0 * M_PI / (double)len * (inverse ? 1.0 : -1.0);
    const cplx wlen(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      cplx w(1.0, 0.0);
      for (size_t k = 0; k < len / 2; ++k) {
        cplx u = a[i + k];
        cplx v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    for (auto& v : a) v /= (double)n;
  }
}

std::vector<cplx> rfft(const std::vector<double>& x) {
  const size_t n = x.size();
  std::vector<cplx> a(n);
  for (size_t i = 0; i < n; ++i) a[i] = cplx(x[i], 0.0);
  fft_inplace(a, false);
  a.resize(n / 2 + 1);
  return a;
}

std::vector<double> irfft(const std::vector<cplx>& X, size_t n) {
  std::vector<cplx> a(n);
  for (size_t i = 0; i <= n / 2; ++i) a[i] = X[i];
  for (size_t i = 1; i < n / 2; ++i) a[n - i] = std::conj(X[i]);
  fft_inplace(a, true);
  std::vector<double> out(n);
  for (size_t i = 0; i < n; ++i) out[i] = a[i].real();
  return out;
}

}  // namespace cvdsp
