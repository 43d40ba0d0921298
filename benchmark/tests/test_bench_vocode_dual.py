"""``voc-vocode-dual`` at a tiny size on the CPU (the program's plain
sampler in place of the kernel): the check passes a sound run and fails
each way the rendering could break, each planted here by monkeypatching
the program: the coarse half's mask left off, the fine half fed c_{t-1} in
place of c_t, the coarse and fine bytes swapped in the assembly, and the
fine head drawing the coarse head's noise.  The limits are the cell's own
(``cells/voc-vocode-dual.json``)."""

import dataclasses
import sys

import pytest
import torch

from benchmark.harness import core, peaks

CELL = "voc-vocode-dual"
SMALL = {"config": {"model": {"hidden_units": 16},
                    "vocoder": {"hidden_units": 16, "cond_dim": 8},
                    "n_smpl_dec": 4, "bucket": 40},
         "traffic": {"frames": [12, 20], "pool_utts": 6, "pairs": 4}}


def run(seed: int = 2**31 + 29, trace: bool = False, dtype=None):
    torch.set_num_threads(2)
    return core.run_cell(core.Cell(CELL), seed, 0.3, trace, torch.device("cpu"), dtype=dtype,
                         overrides=SMALL)


def test_a_sound_run_passes():
    r = run()
    assert r["correct"] is True, r["compared"]
    assert set(r["compared"]) == {"convert_gap", "coarse_gap", "fine_gap"}
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_the_control_fails():
    """The conversion on the program's bfloat16 path: the rendering's
    conditioning moves with it (at this size only the conversion's gap
    reads it; on the card the heads' gaps too)."""
    r = run(dtype="bfloat16")
    assert r["correct"] is False
    c = r["compared"]["convert_gap"]
    assert c["value"] > c["limit"], r["compared"]


def test_a_traced_run_reads_the_program_counts():
    from cyclevae_tpu_torch.utils import profiling
    profiling.reset()
    r = run(trace=True)
    assert r["correct"] is True, r["compared"]
    # device numbers are left out on the CPU; the spans and the work are read
    assert r["metrics"]["vocode_dual.host_ms"]["value"] > 0
    assert r["metrics"]["vocode_dual.mfu_pct"]["value"] > 0
    names = [s.name for s in profiling.spans()]
    assert "vocoder.assemble" in names and "vocoder.generate" in names
    # the plain sampler is no launch: the kernel's steps are counted on the card
    assert "wavernn.steps" not in profiling.counters()


def _mask_left_off(monkeypatch):
    """Where the sampler and the kernel's wrapper take the masked weights."""
    from cyclevae_tpu_torch.models import wavernn
    from cyclevae_tpu_torch.ops import cuda_wavernn
    for mod in (wavernn, cuda_wavernn):
        monkeypatch.setattr(mod, "dual_input_weights",
                            lambda params, cfg: params["gru"]["w_ih"][:, :3])


def _fine_fed_previous_coarse(monkeypatch):
    from cyclevae_tpu_torch.models import wavernn
    real = wavernn.dual_inputs
    monkeypatch.setattr(wavernn, "dual_inputs", lambda c, f, cur: real(c, f, c))


def _bytes_swapped(monkeypatch):
    from cyclevae_tpu_torch.pipeline import vocoder_stage
    real = vocoder_stage.pcm16_decode
    monkeypatch.setattr(vocoder_stage, "pcm16_decode",
                        lambda u16: real(((u16 & 255) << 8) | (u16 >> 8)))


def _fine_draws_coarse_noise(monkeypatch):
    from cyclevae_tpu_torch.ops import cuda_wavernn
    real = cuda_wavernn.philox_uniforms
    monkeypatch.setattr(cuda_wavernn, "philox_uniforms",
                        lambda *a, head=0, **k: real(*a, head=0, **k))


@pytest.mark.parametrize("plant,name", [(_mask_left_off, "coarse_gap"),
                                        (_fine_fed_previous_coarse, "fine_gap"),
                                        (_bytes_swapped, "coarse_gap"),
                                        (_fine_draws_coarse_noise, "fine_gap")],
                         ids=["mask_left_off", "fine_fed_previous_coarse", "bytes_swapped",
                              "fine_draws_coarse_noise"])
def test_a_broken_rendering_fails(monkeypatch, plant, name):
    plant(monkeypatch)
    r = run()
    assert r["correct"] is False
    c = r["compared"][name]
    assert not c["value"] <= c["limit"], r["compared"]


def test_a_program_without_the_dual_output_fails_at_set_up(monkeypatch):
    from cyclevae_tpu_torch.models import wavernn

    @dataclasses.dataclass(frozen=True)
    class Single:
        hidden_units: int = 896

    monkeypatch.setattr(wavernn, "WaveRNNConfig", Single)
    with pytest.raises(SystemExit, match="no dual output"):
        run()


@pytest.mark.parametrize("B", [1, 4])
def test_dual_work_equals_chip_smoke_bound(B):
    """``work/wavernn_dual.py`` counts what ``chip_smoke.py``'s kernel table
    bounds: 6.08 MFLOP a sample at the published widths."""
    sys.path.insert(0, str(core.ROOT))
    import chip_smoke

    class V:
        hidden_units, n_classes = 896, 256
    work = core.load_module(core.HERE / "work" / "wavernn_dual.py", "t_work_wavernn_dual")
    ops, nbytes = work.work(B, 4000, 896, 256)
    want_ms, _ = chip_smoke.wavernn_dual_bound_ms(B, 4000, V)
    assert peaks.bound_s(ops, nbytes) * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert ops / (4000 * B) == 2 * (3 * 896**2 + 2 * 448**2 + 2 * 256 * 448) == 6_078_464
