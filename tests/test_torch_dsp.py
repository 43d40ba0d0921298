"""The port's host DSP (``cyclevae_tpu_torch.dsp``) against the JAX package's
(``cyclevae_tpu.dsp``) on the same inputs (CPU).

Both wrap a C++ library built from the same sources with the same flags on
the same machine, so every wrapper is held bitwise equal.  The tensor ops
(``dsp/torch_ops.py``) are held against ``dsp/jax_ops.py`` on float32 inputs
at the bounds of ``tests/test_jax_ops.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cyclevae_tpu import dsp as jdsp
from cyclevae_tpu.dsp import jax_ops
from cyclevae_tpu.dsp import mlpg as jmlpg
from cyclevae_tpu_torch import dsp as tdsp
from cyclevae_tpu_torch.dsp import _lib, torch_ops
from cyclevae_tpu_torch.dsp import mlpg as tmlpg

ROOT = Path(__file__).resolve().parent.parent
FS = 22050
ALPHA = 0.455


def synth_speechlike(f0, dur, seed, fs=FS):
    """Sawtooth source + two moving formant resonators + breath noise, with
    silence at the edges (the recipe of ``tests/test_e2e_pipeline.py``)."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    n = int(dur * fs)
    t = np.arange(n) / fs
    ph = np.cumsum(f0 * (1.0 + 0.05 * np.sin(2 * np.pi * 2.0 * t))) / fs
    src = 2.0 * (ph % 1.0) - 1.0
    f1 = 600 + 200 * np.sin(2 * np.pi * 1.3 * t)
    out = np.zeros(n)
    for s in range(0, n, 2048):
        e = min(s + 2048, n)
        for fc, bw in ((np.mean(f1[s:e]), 120.0), (1800.0, 200.0)):
            r = np.exp(-np.pi * bw / fs)
            th = 2 * np.pi * fc / fs
            out[s:e] += lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], src[s:e])
    out += 0.01 * rng.normal(size=n)
    env = np.minimum(1.0, np.maximum(0.0, np.sin(np.pi * t / dur) * 1.5))
    return out * env * 8000.0


class Inputs:
    """A ~1 s speech-like wav, its WORLD analysis (from the JAX package), and
    random mel-cepstra, power spectra and MLPG statistics from a seed."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.x = synth_speechlike(120.0, 1.0, seed=0)
        w = jdsp.world
        self.f0_raw, self.t = w.harvest(self.x, FS, f0_floor=70.0, f0_ceil=400.0)
        self.f0 = w.stonemask(self.x, self.f0_raw, self.t, FS)
        self.sp = w.cheaptrick(self.x, self.f0, self.t, FS)
        self.ap = w.d4c(self.x, self.f0, self.t, FS)
        self.coded = w.code_aperiodicity(self.ap, FS)
        self.mc = rng.normal(size=(40, 25)) * 0.3
        self.mc[:, 0] += 2.0
        self.ps = (np.abs(np.fft.rfft(rng.normal(size=(40, 64)), 512, axis=-1)) + 1.0) ** 2
        self.mc_x = jdsp.sptk.sp2mc(self.sp, 49, ALPHA)
        self.mc_y = self.mc_x[::-1][:150] + 0.1 * rng.normal(size=(150, 50))
        self.b = jdsp.sptk.mc2b(0.1 * rng.normal(size=(len(self.f0), 50)), ALPHA)
        self.mean = rng.normal(size=(60, 6))
        self.var = rng.random((60, 6)) + 0.1


@pytest.fixture(scope="module")
def inp():
    return Inputs()


JAX_PKG, PORT_PKG = (jdsp, jmlpg), (tdsp, tmlpg)

# every wrapper of the port's dsp: name -> f((dsp package, mlpg module), inputs)
CASES = {
    "harvest": lambda p, i: p[0].world.harvest(i.x, FS, f0_floor=70.0, f0_ceil=400.0),
    "harvest_default_range": lambda p, i: p[0].world.harvest(i.x, FS),
    "stonemask": lambda p, i: p[0].world.stonemask(i.x, i.f0_raw, i.t, FS),
    "cheaptrick": lambda p, i: p[0].world.cheaptrick(i.x, i.f0, i.t, FS),
    "d4c": lambda p, i: p[0].world.d4c(i.x, i.f0, i.t, FS),
    "code_aperiodicity": lambda p, i: p[0].world.code_aperiodicity(i.ap, FS),
    "decode_aperiodicity": lambda p, i: p[0].world.decode_aperiodicity(i.coded, FS),
    "synthesize": lambda p, i: p[0].world.synthesize(i.f0, i.sp, i.ap, FS, seed=7),
    "sp2mc": lambda p, i: p[0].sptk.sp2mc(i.sp, 49, ALPHA),
    "sp2mc_1d": lambda p, i: p[0].sptk.sp2mc(i.ps[0], 24, ALPHA),
    "mc2sp": lambda p, i: p[0].sptk.mc2sp(i.mc, ALPHA, 512),
    "freqt": lambda p, i: p[0].sptk.freqt(i.mc[0], 30, ALPHA),
    "mc2e": lambda p, i: p[0].sptk.mc2e(i.mc, alpha=ALPHA, irlen=1024),
    "mc2e_direct": lambda p, i: p[0].sptk.mc2e_direct(i.mc[:8], alpha=ALPHA, irlen=256),
    "mc2b": lambda p, i: p[0].sptk.mc2b(i.mc, ALPHA),
    "b2mc": lambda p, i: p[0].sptk.b2mc(i.mc, ALPHA),
    "mlsadf": lambda p, i: p[0].sptk.mlsadf(i.x, i.b, ALPHA, hop=110),
    "calc_mcd": lambda p, i: p[0].dtw.calc_mcd(i.mc_x[:150], i.mc_y),
    "dtw_org_to_trg": lambda p, i: p[0].dtw.dtw_org_to_trg(i.mc_x, i.mc_y),
    "mlpg": lambda p, i: p[1].mlpg(i.mean, i.var),
    "mlpg_accel": lambda p, i: p[1].mlpg(
        np.c_[i.mean, i.mean[:, :3]], np.c_[i.var, i.var[:, :3]],
        (p[1].WIN_STATIC, p[1].WIN_DELTA, p[1].WIN_ACCEL)),
    "apply_delta_windows": lambda p, i: p[1].apply_delta_windows(i.mean[:, :3]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_bitwise_equal_to_jax_package(inp, name):
    want = CASES[name](JAX_PKG, inp)
    got = CASES[name](PORT_PKG, inp)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)


def test_library_is_the_ports_own_copy():
    """The port builds its own library from its own verbatim copy of the
    sources, into the git-ignored build directory, not beside the sources."""
    lib = _lib.get_lib()
    ours, theirs = ROOT / "cyclevae_tpu_torch/dsp/native", ROOT / "cyclevae_tpu/dsp/native"
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(["Makefile", "api.cc"] + [f"{m}.{e}" for m in
                           ("dtw", "fft", "mcep", "mlpg", "pitch", "vocoder")
                           for e in ("cc", "h")])
    for n in names:
        assert (ours / n).read_bytes() == (theirs / n).read_bytes(), n
    assert Path(lib._name).resolve() == (ROOT / "cyclevae_tpu_torch/build/dsp/libcvdsp.so")
    assert lib is not jdsp._lib.get_lib()


# ---- dsp/torch_ops.py against dsp/jax_ops.py (float32) ----

def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


def test_torch_sp2mc_mc2sp_match_jax_ops(inp):
    ps, mc = _f32(inp.ps[:3], inp.mc[:3] * 0.3)
    want = np.asarray(jax_ops.sp2mc(jnp.asarray(ps), 24, ALPHA))
    got = torch_ops.sp2mc(torch.from_numpy(ps), 24, ALPHA).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, tdsp.sptk.sp2mc(ps, 24, ALPHA), rtol=1e-4, atol=1e-5)
    want = np.asarray(jax_ops.mc2sp(jnp.asarray(mc), ALPHA, 512))
    got = torch_ops.mc2sp(torch.from_numpy(mc), ALPHA, 512).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got, tdsp.sptk.mc2sp(mc, ALPHA, 512), rtol=1e-3)


def test_torch_mcd_gv_postfilter_mod_pow_match_jax_ops(inp):
    rng = np.random.default_rng(2)
    x, y = _f32(rng.normal(size=(2, 9, 5)), rng.normal(size=(2, 9, 5)))
    mask = np.asarray([[1] * 6 + [0] * 3, [1] * 9], np.float32)
    for m in (None, mask):
        want = jax_ops.calc_mcd(jnp.asarray(x), jnp.asarray(y),
                                None if m is None else jnp.asarray(m))
        got = torch_ops.calc_mcd(torch.from_numpy(x), torch.from_numpy(y),
                                 None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    _, per_h = tdsp.dtw.calc_mcd(x[0], y[0])
    np.testing.assert_allclose(torch_ops.calc_mcd(torch.from_numpy(x[0]),
                                                  torch.from_numpy(y[0]))[1].numpy(),
                               per_h, rtol=1e-6)

    cv, gv_d, gv_m = _f32(rng.normal(size=(40, 10)), np.abs(rng.normal(size=9)) + 0.5,
                          np.abs(rng.normal(size=9)) + 0.5)
    want = np.asarray(jax_ops.gv_postfilter(*map(jnp.asarray, (cv, gv_d, gv_m))))
    got = torch_ops.gv_postfilter(*map(torch.from_numpy, (cv, gv_d, gv_m))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    mc_ref = rng.normal(size=(6, 25)) * 0.2
    mc_cv = mc_ref + rng.normal(size=(6, 25)) * 0.05
    mc_ref, mc_cv = _f32(mc_ref, mc_cv)
    want = np.asarray(jax_ops.mod_pow_device(jnp.asarray(mc_cv), jnp.asarray(mc_ref),
                                             ALPHA, 1024))
    got = torch_ops.mod_pow_device(torch.from_numpy(mc_cv), torch.from_numpy(mc_ref),
                                   ALPHA, 1024).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])


def test_torch_ops_keep_device_dtype_and_grad(inp):
    mc = torch.tensor(inp.mc[:4] * 0.3, dtype=torch.float64, requires_grad=True)
    sp = torch_ops.mc2sp(mc, ALPHA, 512)
    assert sp.dtype == torch.float64 and sp.device == mc.device
    np.testing.assert_allclose(sp.detach().numpy(), tdsp.sptk.mc2sp(inp.mc[:4] * 0.3, ALPHA, 512),
                               rtol=1e-10)
    back = torch_ops.sp2mc(sp, 24, ALPHA)
    np.testing.assert_allclose(back.detach().numpy(), mc.detach().numpy(), atol=1e-8)
    torch_ops.mod_pow_device(mc, mc.detach() + 0.1, ALPHA, 512).sum().backward()
    assert torch.isfinite(mc.grad).all()
