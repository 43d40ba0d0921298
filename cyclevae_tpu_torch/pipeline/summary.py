"""Experiment summary (a copy of ``cyclevae_tpu/pipeline/summary.py``): the
reference's loss_summary.sh + awk parsers (egs/one-to-one/loss_summary.sh,
proc_loss_log_vae*.awk) replaced by a reader over the structured
``history.json`` the training stage writes.

Prints a per-epoch table and the running-best line (the awk scripts track the
running min of eval mcdpow src->trg mean+std; here the richer criterion from
train_stage is already recorded)."""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def summarize(history_path: str, keys: Optional[List[str]] = None) -> str:
    with open(history_path) as f:
        data = json.load(f)
    history = data["history"]
    best = data.get("best", {})
    if not history:
        return "(empty history)"
    if "train" not in history[0]:
        # flat schema (vocoder stage: {"epoch", "nll", "sec"})
        flat_keys = [k for k in history[0] if k != "epoch"]
        lines = ["epoch  " + "  ".join(f"{k:>12s}" for k in flat_keys)]
        for h in history:
            lines.append(f"{h['epoch']:5d}  " + "  ".join(
                f"{h.get(k, float('nan')):12.3f}" for k in flat_keys))
        return "\n".join(lines)
    keys = keys or ["mcdpow_cv_mean", "mcdpow_cv_std", "mcd_cv_mean",
                    "mcd_cv_std", "mcdpow_rec_mean", "criterion"]
    lines = ["epoch  train_loss  " + "  ".join(f"{k:>16s}" for k in keys)]
    for h in history:
        row = f"{h['epoch']:5d}  {h['train'].get('loss', float('nan')):10.2f}  "
        ev = h.get("eval") or {}
        row += "  ".join(f"{ev.get(k, float('nan')):16.3f}" for k in keys)
        lines.append(row)
    lines.append(f"#min={best.get('criterion', float('nan')):.3f} "
                 f"@epoch {best.get('epoch', -1)}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="summarize a training history")
    p.add_argument("history", help="path to expdir/history.json")
    p.add_argument("--keys", nargs="*", default=None)
    args = p.parse_args(argv)
    print(summarize(args.history, args.keys))


if __name__ == "__main__":
    main()
