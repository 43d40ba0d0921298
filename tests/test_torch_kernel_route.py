"""The port's defaults take the kernel route, its kernel builds are safe
from several threads and processes, and its launch counts stay exact when
threads launch kernels.

The CPU tests run the kernels' plain versions and build with a stand-in
compiler; the ``cuda`` test builds the real sources with ``nvcc`` on the
card.  The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_route.py -q
"""

import stat
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.models import gru_vae
from cyclevae_tpu_torch.ops import _build, cuda_gru, cuda_wavernn
from cyclevae_tpu_torch.pipeline.decode import Codec, device_decode_pair
from cyclevae_tpu_torch.pipeline.train_stage import model_config
from cyclevae_tpu_torch.utils.config import ExperimentConfig, ModelConfig
from cyclevae_tpu_torch.vi.train import (CycleVAEConfig, TrainState, init_cyclevae,
                                         make_optimizer, make_train_step)

torch.set_num_threads(1)


def test_config_defaults_select_the_kernel_route():
    assert ModelConfig().use_pallas is True
    assert CycleVAEConfig().use_pallas is True
    assert model_config(ExperimentConfig()).use_pallas is True


@pytest.fixture
def routes(monkeypatch):
    """Calls of the plain scan and of the fused kernels' wrappers."""
    calls = {"scan": 0, "k1": 0, "fused": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(gru_vae, "gru_ar_scan", counting("scan", gru_vae.gru_ar_scan))
    monkeypatch.setattr(gru_vae, "cuda_gru_ar", counting("k1", gru_vae.cuda_gru_ar))
    monkeypatch.setattr(gru_vae, "gru_ar_fused", counting("fused", gru_vae.gru_ar_fused))
    return calls


@pytest.mark.parametrize("use_pallas", [None, False])
def test_codec_and_train_step_route(routes, use_pallas):
    """Built from the defaults, a Codec runs K1 and a train step runs the
    fused K2/K3 path; ``use_pallas=False`` runs the plain scan."""
    kw = {} if use_pallas is None else {"use_pallas": use_pallas}
    cfg = CycleVAEConfig(hidden_units=8, n_cyc=1, **kw)
    params = init_cyclevae(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    codec = Codec(params, cfg, n_smpl_dec=2, bucket=8, device="cpu")
    codec.encode_mean(torch.Generator().manual_seed(1), [rng.normal(size=(11, 54))])
    after_codec = dict(routes)
    opt = make_optimizer(cfg, lr=1e-3)
    ts = TrainState(params, opt.init(params), torch.Generator().manual_seed(2), 0)
    feats = rng.normal(size=(2, 16, 54)).astype(np.float32)
    code = np.zeros((2, 16, 2), np.float32)
    make_train_step(cfg, opt, 8, 2)(ts, {"feats": feats, "src_code": code + [1, 0],
                                         "trg_code": code + [0, 1], "cv_excit": feats[..., :4],
                                         "flens": np.array([16, 12])})
    if use_pallas is None:
        assert after_codec == {"scan": 0, "k1": 1, "fused": 0}
        assert routes == {"scan": 0, "k1": 1, "fused": 2 * 4}   # 2 segments x 4 calls
    else:
        assert after_codec == {"scan": 1, "k1": 0, "fused": 0}
        assert routes == {"scan": 1 + 2 * 4, "k1": 0, "fused": 0}


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """A fresh source tree and build directory, and a stand-in compiler
    that logs each run, waits, and links a tiny C library with
    ``cuda_error_string``."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "x.cu").write_text("// a source\n")
    c_src = tmp_path / "stub.c"
    c_src.write_text('const char* cuda_error_string(int e) { return "stub"; }\n')
    runs = tmp_path / "runs.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import subprocess, sys, time\n"
        f"open({str(runs)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "time.sleep(0.5)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"subprocess.run(['cc', '-shared', '-fPIC', '-o', out, {str(c_src)!r}], check=True)\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LOADED", {})
    return build, runs


def _together(n, fn):
    """Run ``fn`` on n threads started at once; their results, in order."""
    barrier = threading.Barrier(n)
    out = [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def test_two_threads_load_one_fresh_source_once(stub_build):
    build, runs = stub_build
    libs = _together(2, lambda: _build.load("x"))
    assert libs[0] is libs[1]
    assert libs[0].cuda_error_string(0) == b"stub"
    assert len(runs.read_text().splitlines()) == 1
    assert sorted(p.name for p in build.glob("*.so")) == [_build.library_path("x").name]
    assert not list(build.glob("*.tmp"))


def test_builds_from_threads_and_processes_compile_once(stub_build):
    """``build`` itself holds a file lock: threads that bypass ``load``, and
    another process, wait for the first compile and then find the library."""
    build, runs = stub_build
    paths = _together(3, lambda: _build.build(["x"]))
    assert paths[0] == paths[1] == paths[2]
    code = ("import sys; from pathlib import Path; from cyclevae_tpu_torch.ops import _build; "
            f"_build.CSRC = Path({str(_build.CSRC)!r}); _build.BUILD = Path({str(build)!r}); "
            "_build._nvcc = lambda: 'false'; print(_build.build(['x'])['x'])")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parent.parent, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(paths[0]["x"])
    assert len(runs.read_text().splitlines()) == 1


def test_launch_counts_exact_under_threads():
    wrappers = (cuda_gru.cuda_gru_ar, cuda_gru.cuda_gru_ar_train, cuda_gru.cuda_gru_ar_bwd,
                cuda_wavernn.cuda_wavernn_generate)
    before = [w.launches for w in wrappers]
    n_threads, per_thread = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(n_threads, lambda: [_build.count_launch(w) for _ in range(per_thread)
                                      for w in wrappers])
    finally:
        sys.setswitchinterval(interval)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [n_threads * per_thread] * 4
    for w, b in zip(wrappers, before):
        w.launches = b


def test_concurrent_requests_reach_the_device_one_at_a_time():
    """Stage 6 decodes pairs on a thread pool: the device phase of one
    request (``Codec.convert_pair``: the encode, posterior mean and batched
    decode, then the copy to the host) never overlaps another's, and each
    request's outputs are those of a serial run with the same generator."""
    cfg = CycleVAEConfig(hidden_units=8, n_cyc=1)
    codec = Codec(init_cyclevae(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg,
                  n_smpl_dec=2, bucket=8, device="cpu")
    rng = np.random.default_rng(1)
    pairs = [(rng.normal(size=(9 + i, 54)), rng.normal(size=(12, 54))) for i in range(6)]
    serial = [device_decode_pair(codec, torch.Generator().manual_seed(i), *p)
              for i, p in enumerate(pairs)]
    active, peak, guard = [0], [0], threading.Lock()

    def watched(fn):
        def call(*a, **k):
            with guard:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.02)
            try:
                return fn(*a, **k)
            finally:
                with guard:
                    active[0] -= 1
        return call

    codec.convert_pair = watched(codec.convert_pair)
    barrier = threading.Barrier(len(pairs))
    got = [None] * len(pairs)

    def run(i):
        barrier.wait()
        got[i] = device_decode_pair(codec, torch.Generator().manual_seed(i), *pairs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(pairs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert peak[0] == 1
    for g, w in zip(got, serial):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_two_threads_build_the_real_kernel_once(tmp_path, monkeypatch):
    """On the card: two threads load one kernel source into an empty build
    directory; nvcc runs once and both get the same library."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    libs = _together(2, lambda: _build.load("gru_ar"))
    assert libs[0] is libs[1]
    assert len(list((tmp_path / "build").glob("*.so"))) == 1
    assert len(list((tmp_path / "build").glob("*.log"))) == 1
    grid, units, *_ = cuda_gru.plan(libs[0], 3, 1024, 50, torch.float32, device=0)
    assert grid * units >= 1024
