"""ctypes loader for the native DSP library (builds on demand with make).

The port's copy of ``cyclevae_tpu/dsp/_lib.py``. The sources and Makefile in
``native/`` are a verbatim copy of the JAX package's; ``make`` runs them with
the build directory as its working directory and ``native/`` as its VPATH, so
the objects and ``libcvdsp.so`` land in the git-ignored
``cyclevae_tpu_torch/build/dsp/`` and the source tree stays clean. The
Makefile compiles with ``-march=native``, so the library is built on the
machine that loads it. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "build", "dsp")
_LIB_PATH = os.path.join(_BUILD_DIR, "libcvdsp.so")
_lock = threading.Lock()
_lib = None

_d = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
c_int = ctypes.c_int
c_dbl = ctypes.c_double
c_u64 = ctypes.c_uint64


def _build():
    subprocess.run(["make", "-C", _BUILD_DIR, "-f", os.path.join(_NATIVE_DIR, "Makefile"),
                    f"VPATH={_NATIVE_DIR}", "-s", f"-j{os.cpu_count() or 1}"], check=True)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # CYCLEVAE_DSP_LIB pins an exact prebuilt library (feature
        # reproducibility: decode with the same DSP build that extracted a
        # model's training features, even after the in-tree DSP evolves)
        override = os.environ.get("CYCLEVAE_DSP_LIB")
        if override:
            path = override
            lib = ctypes.CDLL(path)
        else:
            # Cross-process exclusive flock held across check+build+dlopen:
            # several processes (test workers, stage-1 workers) may get_lib()
            # at once — without this, concurrent `make` runs race writing
            # libcvdsp.so and a process can dlopen a half-written library.
            path = _LIB_PATH
            os.makedirs(_BUILD_DIR, exist_ok=True)
            with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    if not os.path.exists(path):
                        _build()
                    else:
                        # rebuild if any source is newer than the library
                        lib_mtime = os.path.getmtime(path)
                        for f in os.listdir(_NATIVE_DIR):
                            if f.endswith((".cc", ".h")) and os.path.getmtime(
                                    os.path.join(_NATIVE_DIR, f)) > lib_mtime:
                                _build()
                                break
                    lib = ctypes.CDLL(path)
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)

        lib.cvdsp_n_frames.restype = c_int
        lib.cvdsp_n_frames.argtypes = [c_int, c_int, c_dbl]
        lib.cvdsp_estimate_f0.restype = None
        lib.cvdsp_estimate_f0.argtypes = [_d, c_int, c_int, c_dbl, c_dbl, c_dbl, _d, _d]
        lib.cvdsp_refine_f0.restype = None
        lib.cvdsp_refine_f0.argtypes = [_d, c_int, c_int, _d, _d, c_int, _d]
        lib.cvdsp_spectral_envelope.restype = None
        lib.cvdsp_spectral_envelope.argtypes = [_d, c_int, c_int, _d, _d, c_int, c_int, _d]
        lib.cvdsp_aperiodicity.restype = None
        lib.cvdsp_aperiodicity.argtypes = [_d, c_int, c_int, _d, _d, c_int, c_int, _d]
        lib.cvdsp_n_coded_aperiodicity.restype = c_int
        lib.cvdsp_n_coded_aperiodicity.argtypes = [c_int]
        lib.cvdsp_code_aperiodicity.restype = None
        lib.cvdsp_code_aperiodicity.argtypes = [_d, c_int, c_int, c_int, _d]
        lib.cvdsp_decode_aperiodicity.restype = None
        lib.cvdsp_decode_aperiodicity.argtypes = [_d, c_int, c_int, c_int, _d]
        lib.cvdsp_synthesis_length.restype = c_int
        lib.cvdsp_synthesis_length.argtypes = [c_int, c_int, c_dbl]
        lib.cvdsp_synthesize.restype = None
        lib.cvdsp_synthesize.argtypes = [_d, _d, _d, c_int, c_int, c_dbl, c_int, c_u64, _d]
        lib.cvdsp_sp2mc.restype = None
        lib.cvdsp_sp2mc.argtypes = [_d, c_int, c_int, c_dbl, c_int, _d]
        lib.cvdsp_mc2sp.restype = None
        lib.cvdsp_mc2sp.argtypes = [_d, c_int, c_int, c_dbl, c_int, _d]
        lib.cvdsp_freqt.restype = None
        lib.cvdsp_freqt.argtypes = [_d, c_int, c_int, c_dbl, _d]
        lib.cvdsp_mc2e.restype = None
        lib.cvdsp_mc2e.argtypes = [_d, c_int, c_int, c_dbl, c_int, _d]
        lib.cvdsp_mc2e_direct.restype = None
        lib.cvdsp_mc2e_direct.argtypes = [_d, c_int, c_int, c_dbl, c_int, _d]
        lib.cvdsp_mc2b.restype = None
        lib.cvdsp_mc2b.argtypes = [_d, c_int, c_int, c_dbl, _d]
        lib.cvdsp_b2mc.restype = None
        lib.cvdsp_b2mc.argtypes = [_d, c_int, c_int, c_dbl, _d]
        lib.cvdsp_mlsadf.restype = None
        lib.cvdsp_mlsadf.argtypes = [_d, c_int, _d, c_int, c_int, c_dbl, c_int, _d]
        lib.cvdsp_mlpg.restype = c_int
        lib.cvdsp_mlpg.argtypes = [_d, _d, c_int, c_int, _d, _i32, c_int, _d]
        lib.cvdsp_calc_mcd.restype = c_dbl
        lib.cvdsp_calc_mcd.argtypes = [_d, _d, c_int, c_int, _d]
        lib.cvdsp_dtw_org_to_trg.restype = c_dbl
        lib.cvdsp_dtw_org_to_trg.argtypes = [_d, c_int, _d, c_int, c_int, _i32, _d]

        _lib = lib
        return lib


def as_f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)
