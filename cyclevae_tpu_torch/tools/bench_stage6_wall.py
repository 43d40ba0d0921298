"""Stage 6's wall time on a quiet host, analysis prefetch on against off.

Port of the JAX package's ``tools/bench_stage6_wall.py``.  Runs stage 6
(every eval pair converted, wav in to wavs out) through the recipe's command
line, ``python -m cyclevae_tpu_torch --stage 6``, twice: with
``CYCLEVAE_PREFETCH=1`` (the producer/consumer pipeline: analyses on worker
threads ahead of the decodes, syntheses overlapping the next device call,
``pipeline/recipe.py``) and with ``CYCLEVAE_PREFETCH=0`` (one pair at a
time: analyse, decode, synthesise).  Each run is timed on the host clock
around its process.

Both runs must do the same work: before each run the tool removes the
stage-6 outputs of the decode epoch (``decode_metrics_ep<E>.json``, the
wavs of ``wav_cv_ep<E>/``), and after it reads them back; ``outputs_equal``
is true when the two runs wrote the same metrics and the same wav bytes.
Anything else is a fault: the tool says so and exits 1.

Run it with no other CPU load on the host (the battery's ``quiet`` phase).

    python -m cyclevae_tpu_torch.tools.bench_stage6_wall --work W --wav-root R
        [--config W/flagship_config.json] [--decode-epoch E] [--conf-dir C]
        [--n-jobs N] [--skip-baseline] [--out BENCH_TORCH_STAGE6_WALL.json] [--device cpu]

The last stdout line is the JSON artifact (the battery's contract).

Reference counterpart: decode_gru-cyclevae_gauss.py:309-323 (5 sequential
forwards per pair, no overlap).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Optional

from ._common import REPO, add_device_arg, decode_epoch, device_entry, resolve_device
from ._common import write_json


def run_stage6(work: str, wav_root: str, config: str, epoch: int, prefetch: bool,
               device: str, conf_dir: Optional[str] = None,
               n_jobs: Optional[int] = None) -> float:
    """Seconds of one ``--stage 6`` process (paths absolute: it runs in the
    repository's root)."""
    env = dict(os.environ)
    env["CYCLEVAE_PREFETCH"] = "1" if prefetch else "0"
    cmd = [sys.executable, "-m", "cyclevae_tpu_torch", "--stage", "6", "--work", work,
           "--wav-root", wav_root, "--config", config, "--decode-epoch", str(epoch),
           "--device", device]
    if conf_dir:
        cmd += ["--conf-dir", conf_dir]
    if n_jobs is not None:
        cmd += ["--n-jobs", str(n_jobs)]
    print("+", " ".join(cmd), f"(PREFETCH={env['CYCLEVAE_PREFETCH']})", flush=True)
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, text=True)
    except subprocess.CalledProcessError as e:
        sys.stderr.write(e.stderr[-4000:])
        raise
    return time.perf_counter() - t0


def _outputs(expdir: str, epoch: int):
    """(metrics path, the wav paths) stage 6 writes for ``epoch``."""
    return (os.path.join(expdir, f"decode_metrics_ep{epoch}.json"),
            sorted(glob.glob(os.path.join(expdir, f"wav_cv_ep{epoch}", "*.wav"))))


def clear_outputs(expdir: str, epoch: int) -> None:
    metrics, wavs = _outputs(expdir, epoch)
    for path in [metrics] + wavs:
        if os.path.exists(path):
            os.remove(path)


def read_outputs(expdir: str, epoch: int) -> dict:
    """The metrics stage 6 wrote and the sha256 of each of its wavs."""
    metrics, wavs = _outputs(expdir, epoch)
    with open(metrics) as f:
        got = {"metrics": json.load(f)}
    for path in wavs:
        with open(path, "rb") as f:
            got[os.path.basename(path)] = hashlib.sha256(f.read()).hexdigest()
    return got


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True, help="the recipe's work directory")
    ap.add_argument("--wav-root", required=True,
                    help="wav corpus: <spk>/*.wav and eval/<spk>/*.wav")
    ap.add_argument("--config", default=None, help="defaults to <work>/flagship_config.json")
    ap.add_argument("--decode-epoch", type=int, default=None,
                    help="default: the best epoch of history.json, as the recipe takes it")
    ap.add_argument("--conf-dir", default=None, help="dir with <spk>.f0/<spk>.pow")
    ap.add_argument("--n-jobs", type=int, default=None)
    ap.add_argument("--skip-baseline", action="store_true",
                    help="skip the slow CYCLEVAE_PREFETCH=0 sequential run")
    ap.add_argument("--out", default="BENCH_TORCH_STAGE6_WALL.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..pipeline.recipe import RecipePaths
    from ..utils.config import load_config

    work, wav_root = os.path.abspath(args.work), os.path.abspath(args.wav_root)
    config = os.path.abspath(args.config or os.path.join(work, "flagship_config.json"))
    conf_dir = os.path.abspath(args.conf_dir) if args.conf_dir else None
    exp = load_config(config)
    expdir = os.path.join(work, "exp", exp.name())
    epoch = decode_epoch(expdir, args.decode_epoch)
    paths = RecipePaths(wav_root, work)
    n_pairs = min(len(paths.wavs(exp.model.spk_src, True)),
                  len(paths.wavs(exp.model.spk_trg, True)))

    def timed_run(prefetch: bool):
        clear_outputs(expdir, epoch)
        t = run_stage6(work, wav_root, config, epoch, prefetch, str(dev), conf_dir, args.n_jobs)
        return t, read_outputs(expdir, epoch)

    t_overlap, first = timed_run(True)
    print(f"overlap pipeline: {t_overlap:.1f} s", flush=True)
    t_seq = equal = None
    if not args.skip_baseline:
        t_seq, second = timed_run(False)
        equal = second == first
        print(f"sequential baseline: {t_seq:.1f} s", flush=True)
        if not equal:
            print("bench_stage6_wall: the prefetch and sequential runs wrote different "
                  "outputs", file=sys.stderr, flush=True)

    out = {"metric": f"stage6_wall_seconds_{n_pairs}_pairs_quiet_host",
           "value": round(t_overlap, 3),
           "sequential_baseline_s": round(t_seq, 3) if t_seq else None,
           "overlap_speedup": round(t_seq / t_overlap, 3) if t_seq else None,
           "decode_epoch": epoch,
           "r3_prefusion_quiet_host_s": None, "r4_contended_s": None,
           "device": device_entry(dev), "n_pairs": n_pairs, "outputs_equal": equal}
    write_json(args.out, out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(1 if main()["outputs_equal"] is False else 0)
