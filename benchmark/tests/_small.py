"""Shared by the benchmark's CPU tests: a run of a cell at a tiny size on
the CPU, through the harness's own path (the look for a card skipped).
The cells held back from ``BENCHMARK.json`` (``held_back.json``) run here
too, so that their harness stays whole until they are listed again."""

import json

import torch

from benchmark.harness import core

LISTED = core.load_json(core.ROOT / "BENCHMARK.json")
HELD_BACK = core.load_json(core.HERE / "held_back.json")
ALL = {**LISTED, **{k: LISTED[k] + HELD_BACK[k]
                    for k in ("workloads", "end_to_end", "per_layer")}}
CELLS = [w["name"] for w in ALL["workloads"]]


def cell_entry(name: str) -> core.Cell:
    return core.Cell(name, ALL)


SMALL = {"config": {"model": {"hidden_units": 16},
                    "vocoder": {"hidden_units": 16, "n_classes": 16, "embed_dim": 8,
                                "cond_dim": 8, "fc_dim": 8},
                    "n_smpl_dec": 4, "bucket": 40, "seg_len": 10, "batch_size_utt": 3},
         "traffic": {"frames": [30, 60], "n_segs": 6, "step_frames": [35, 42, 51],
                     "batches": 4,
                     "pool_utts": 6, "pairs": 4, "utt_frames": 12, "chains": 2,
                     "n_warmup": 4, "n_samples": 4, "n_leapfrog": 2, "check_transitions": 2}}


def run_small(cell: str, seed: int = 2**31 + 11, dtype=None, trace: bool = False,
              seconds: float = 0.5, hidden_units: int = 16, **traffic):
    torch.set_num_threads(2)
    over = json.loads(json.dumps(SMALL))
    over["config"]["model"]["hidden_units"] = hidden_units
    over["traffic"].update(traffic)
    return core.run_cell(cell_entry(cell), seed, seconds, trace, torch.device("cpu"),
                         dtype=dtype, overrides=over)
