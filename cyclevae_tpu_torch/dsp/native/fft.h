// Minimal self-contained FFT utilities for the DSP library.
// Power-of-two iterative radix-2 complex FFT + real helpers.
#pragma once

#include <cmath>
#include <complex>
#include <cstddef>
#include <vector>

namespace cvdsp {

using cplx = std::complex<double>;

// In-place iterative radix-2 FFT. n must be a power of two.
void fft_inplace(std::vector<cplx>& a, bool inverse);

// Real FFT: input n real samples (n power of two) -> n/2+1 complex bins.
std::vector<cplx> rfft(const std::vector<double>& x);

// Inverse real FFT: n/2+1 bins -> n real samples.
std::vector<double> irfft(const std::vector<cplx>& X, size_t n);

inline size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace cvdsp
