"""The yardstick's arithmetic: model FLOPs a frame, each kernel's operations
and bytes, and the rule that only real frames are counted."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import core, peaks
from benchmark.work import cyclevae as work

ROOT = Path(__file__).resolve().parents[2]
FLAGSHIP = core.load_json(ROOT / "benchmark/configs/cyclevae-o2o-hu1024.json")["model"]
K = {k: core.load_module(ROOT / f"benchmark/kernels/{k}.py", f"t_kernel_{k}") for k in core.KERNELS}


def test_flagship_flops_per_trained_frame():
    assert work.encoder_flops(FLAGSHIP) == 10_274_120
    assert work.decoder_flops(FLAGSHIP) == 8_768_392
    assert work.train_flops_per_frame(FLAGSHIP) == 93_706_832


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    return cs


# PERF.md's kernel table: (kernel, B, T, out, bound ms as the table gives it)
TABLE = [("K1", 2, 1120, 64, 0.228), ("K1", 3, 1120, 50, 0.336), ("K1", 16, 800, 50, 1.2802),
         ("K2", 5, 80, 64, 0.0407), ("K2", 10, 80, 50, 0.0800), ("K2", 8, 800, 50, 0.6401),
         ("K3", 5, 80, 64, 0.0806), ("K3", 10, 80, 50, 0.1588), ("K3", 8, 800, 50, 1.2704)]


@pytest.mark.parametrize("kernel,B,T,out,table_ms", TABLE)
def test_gru_kernels_equal_chip_smoke_bounds(chip_smoke, kernel, B, T, out, table_ms):
    fn = {"K1": chip_smoke.gru_ar_bound_ms, "K2": chip_smoke.gru_ar_train_bound_ms,
          "K3": chip_smoke.gru_ar_bwd_bound_ms}[kernel]
    want_ms, _ = fn(B, T, out, torch.float32)
    ops, nbytes = K[kernel].work(B, T, 1024, out)
    got_ms = peaks.bound_s(ops, nbytes) * 1e3
    assert got_ms == pytest.approx(want_ms, rel=1e-12)
    assert round(got_ms, len(str(table_ms).split(".")[1])) == pytest.approx(table_ms)


@pytest.mark.parametrize("B,table_ms", [(1, 0.3052), (4, 1.2207)])
def test_k4_equals_chip_smoke_bound(chip_smoke, B, table_ms):
    class V:
        hidden_units, n_classes, fc_dim = 896, 256, 128
    want_ms, _ = chip_smoke.wavernn_bound_ms(B, 4000, V)
    ops, nbytes = K["K4"].work(B, 4000, 896, 256, 128)
    assert peaks.bound_s(ops, nbytes) * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert round(want_ms, 4) == pytest.approx(table_ms)


def _train_driver(flens, seg_len=80, n_segs=12):
    drv = core.load_module(ROOT / "benchmark/drivers/train.py", "t_driver_train")
    d = drv.Driver({"model": FLAGSHIP, "seg_len": seg_len, "batch_size_utt": 5},
                   {"n_segs": n_segs}, 0,
                   torch.device("cpu"), "float32")
    return d._work(np.asarray(flens))


def test_train_work_counts_real_frames_only():
    # full segments: the needed work of a segment equals the launched shape's
    full = _train_driver([80] * 5, n_segs=12)
    m = FLAGSHIP
    want = 0.0
    for rows, out in ((5, 64), (10, 50), (5, 64), (5, 50)):
        want += 2 * K["K2"].work(rows, 80, 1024, out)[0]
    assert full["K2.flops"] == pytest.approx(want, rel=1e-12)
    assert full["frames"] == 400
    # a step padded to 12 segments whose utterances end early counts only
    # their frames: padding, masked rows and skipped segments are not work
    short = _train_driver([85, 10, 0, 0, 0], n_segs=12)
    assert short["frames"] == 95
    assert short["K2.flops"] == pytest.approx(full["K2.flops"] * 95 / 400, rel=1e-12)
    assert short["model_flops"] == 3 * 93_706_832 * 95
    assert short["K3.flops"] / short["K2.flops"] == pytest.approx(
        full["K3.flops"] / full["K2.flops"], rel=1e-12)


def test_inference_work_counts_L_evaluations_a_transition():
    drv = core.load_module(ROOT / "benchmark/drivers/hmc.py", "t_driver_hmc")
    tr = core.load_json(ROOT / "benchmark/traffic/infer-hmc.json")
    w = drv.Driver({"model": FLAGSHIP}, tr, 0, torch.device("cpu"), "float32")._work()
    n, L, C, T = 200, 8, 8, 400
    assert w["K2.flops"] == n * L * K["K2"].work(C, T, 1024, 50)[0]
    assert w["K3.bytes"] == n * L * K["K3"].work(C, T, 1024, 50)[1]
    # each evaluation a decoder forward and its input gradient; then the 16
    # predictive decodes
    assert w["model_flops"] == (n * L * 2 * C + 16) * 8_768_392 * T
    assert w["draws"] == n * C


def test_conversion_work_counts_real_frames():
    conv = core.load_module(ROOT / "benchmark/drivers/_conversion.py", "t_conversion")
    w = conv.conversion_work(FLAGSHIP, [600, 500], [600, 600, 500])
    enc = K["K1"].work(2, 550, 1024, 64)
    dec = K["K1"].work(3, 1700 / 3, 1024, 50)
    assert w["K1.flops"] == pytest.approx(enc[0] + dec[0], rel=1e-12)
    assert w["model_flops"] == 10_274_120 * 1100 + 8_768_392 * 1700


def test_shares_stay_under_their_peaks():
    ops, nbytes = K["K1"].work(2, 1120, 1024, 64)
    assert peaks.bound_s(ops, nbytes) == pytest.approx(ops / peaks.F32_FLOPS)
    assert math.isclose(peaks.bound_s(0, peaks.HBM_BYTES), 1.0)
