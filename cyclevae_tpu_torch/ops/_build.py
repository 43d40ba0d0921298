"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface, ``build/lib<name>-<hash>.so`` inside this package, at first use;
the hash covers the source, the headers beside it and the flags, so an edited
source builds anew and a stale library is never loaded.  Nothing is built when
a module is imported.  Every C entry point returns its ``cudaError_t``; the
caller raises when it is not 0 (``error_string`` names it).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

from ..utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with ``-D`` each of
    ``defines``) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str], defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` per source, all started together.  Returns name -> library path;
    the compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``.  Another thread or process
    building at the same time waits on the lock and then finds the
    libraries built."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name, defines) for name in names}
    with open(BUILD / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _compile({name: lib for name, lib in paths.items() if not lib.exists()}, defines)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


def _compile(missing: Dict[str, Path], defines: Tuple[str, ...]) -> None:
    nvcc = _nvcc() if missing else ""
    procs = {}
    for name, lib in missing.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


_LOAD_LOCK = threading.Lock()
_LOADED: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed; opened
    once per process, whichever thread asks first."""
    with _LOAD_LOCK:
        lib = _LOADED.get((name, defines))
        if lib is None:
            with span("kernel.build"):
                lib = ctypes.CDLL(str(build([name], defines)[name]))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LOADED[(name, defines)] = lib
        return lib


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, a kernel wrapper's launch count:
    ``+=`` on an attribute reads and writes in two steps that threads can
    interleave."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{what} failed: CUDA error {err} "
            f"({lib.cuda_error_string(err).decode()})")
