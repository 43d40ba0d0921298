// F0 estimation + refinement (WORLD harvest/stonemask capability class).
//
// Clean-room design (NOT a WORLD port): normalized cross-correlation (NCCF)
// candidate generation per frame + Viterbi continuity tracking with
// octave-jump and voicing-transition costs, then harmonic instantaneous-
// frequency refinement of voiced frames.
// Reference call sites replaced: pw.harvest/pw.stonemask in
// feature_extract_vc.py:88-99 and decode…py analysis.
#pragma once

#include <vector>

namespace cvdsp {

struct PitchResult {
  std::vector<double> f0;         // per frame; 0 = unvoiced
  std::vector<double> time_axis;  // seconds
};

// x: waveform (any scale), fs: sample rate, frame_period in ms.
PitchResult estimate_f0(const double* x, int n, int fs, double frame_period,
                        double f0_floor, double f0_ceil);

// Refine an existing f0 track against the waveform's harmonic structure
// (stonemask capability class).
std::vector<double> refine_f0(const double* x, int n, int fs,
                              const std::vector<double>& time_axis,
                              const std::vector<double>& f0);

}  // namespace cvdsp
