"""The check fails a broken program: each test drives a whole run at a tiny
size on the CPU (the look for a card skipped) with the timed path broken
underneath, and sees ``correct`` come out false; and the control, the
program's own bfloat16 path, fails it too.  The limits are the cells' own
(``cells/<cell>.json``)."""

import numpy as np
import pytest
import torch

from benchmark import faults
from benchmark.tests._small import run_small

# the sampler's first step size in the accept test's fault: too long for the
# few warm-up steps at this size to shorten, so that proposals are rejected
STEP = 0.2


def _failed(r, name=None):
    assert r["correct"] is False
    if name is not None:
        c = r["compared"][name]
        assert not c["value"] <= c["limit"], r["compared"]


def test_train_step_that_leaves_its_state_unchanged(monkeypatch):
    faults.train_state_unchanged(monkeypatch.setattr)
    _failed(run_small("o2o-train-bsu5"), "followed_update_gap")


def test_train_step_that_leaves_out_half_the_batch(monkeypatch):
    faults.train_half_batch(monkeypatch.setattr)
    r = run_small("o2o-train-bsu5")
    _failed(r)
    # the later updates, followed from the program's own state, see it too
    c = r["compared"]["followed_loss_gap"]
    assert c["value"] > c["limit"]


def _altered_decode(monkeypatch, which):
    import cyclevae_tpu_torch.pipeline.decode as decode
    real = decode.device_decode_pair

    def broken(*a, **k):
        out = list(real(*a, **k))
        out[which] = out[which].copy()
        out[which][len(out[which]) // 2, 3] += 1.0
        return tuple(out)

    monkeypatch.setattr(decode, "device_decode_pair", broken)


@pytest.mark.parametrize("which,name", [(0, "latent_gap"), (2, "decoded_gap"),
                                        (4, "decoded_gap")])
def test_conversion_with_an_answer_altered(monkeypatch, which, name):
    _altered_decode(monkeypatch, which)
    _failed(run_small("o2o-convert"), name)


def test_vocoded_conversion_altered(monkeypatch):
    _altered_decode(monkeypatch, 2)
    _failed(run_small("voc-vocode"), "convert_gap")


def test_rendering_with_a_sample_altered(monkeypatch):
    import cyclevae_tpu_torch.pipeline.vocoder_stage as vs
    from cyclevae_tpu_torch.models.wavernn import mulaw_decode
    real = vs.synthesize_vocoder

    def broken(params, cfg, feats, **k):
        y = real(params, cfg, feats, **k).copy()
        tab = mulaw_decode(torch.arange(cfg.n_classes), cfg.n_classes).numpy()
        t = len(y) // 3
        y[t] = tab[(int(np.abs(tab - y[t]).argmin()) + cfg.n_classes // 2) % cfg.n_classes]
        return y

    monkeypatch.setattr(vs, "synthesize_vocoder", broken)
    _failed(run_small("voc-vocode"), "k4_gap")


@pytest.mark.parametrize("cell", ["o2o-train-bsu5", "voc-vocode", "o2o-convert",
                                  "o2o-infer-hmc"])
def test_the_control_fails(cell):
    """The program's bfloat16 path in place of float32: the step a later
    change might take; at this size as on the card it fails a limit (the
    sampler's at a width of 64 and 24 frames: at 16 units its bfloat16
    products round too little to show)."""
    size = {"hidden_units": 64, "utt_frames": 24} if cell == "o2o-infer-hmc" else {}
    _failed(run_small(cell, dtype="bfloat16", **size))


def test_hmc_transition_that_leaves_its_state_unchanged(monkeypatch):
    faults.hmc_state_unchanged(monkeypatch.setattr)
    _failed(run_small("o2o-infer-hmc"), "accept_mismatch")


def test_hmc_sample_altered(monkeypatch):
    faults.hmc_sample_altered(monkeypatch.setattr)
    _failed(run_small("o2o-infer-hmc"), "median_chain_gap")


def test_hmc_sampler_that_accepts_every_proposal(monkeypatch):
    """The accept test skipped: the median chain moves only where the
    reference rejects, and the count of decisions that differ sees it."""
    faults.hmc_always_accept(monkeypatch.setattr)
    _failed(run_small("o2o-infer-hmc", step_size=STEP, chains=4), "accept_mismatch")


def test_a_number_without_a_limit_fails(monkeypatch):
    """A compared number that its cell's file gives no limit fails the run."""
    from benchmark.harness import core
    real = core.Cell.__init__

    def without(self, *a, **k):
        real(self, *a, **k)
        self.limits = {}

    monkeypatch.setattr(core.Cell, "__init__", without)
    r = run_small("o2o-convert")
    assert r["correct"] is False
    assert all(c["limit"] is None for c in r["compared"].values())
