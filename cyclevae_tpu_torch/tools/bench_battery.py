"""The bench battery: the port's benches one after another, each in its own
process under a time limit, artifacts written only from output that parses.

Port of the JAX package's ``tools/bench_battery.sh``, in Python so that its
rules can be tested.  It probes the card first (one tiny CUDA op in a
process with a 90 s limit; ``--wait-s`` bounds the retries, one every 300 s,
after which it raises; no probe with ``--device cpu``), then runs a phase's
benches in turn, one process on the card at a time:

  infer -- the device-bound sampler sweeps (HMC chains with mass adaptation
           on and off, NUTS depths, SMC particles, HMC trajectory lengths);
           each writes its own ``--out`` artifact; a CPU job may run beside
  quiet -- the host-sensitive benches: the train-throughput bench, the train
           step's breakdown at bsu 64 (where the JAX battery runs
           ``bench_step_gap.py 64 10``, which has no counterpart in the
           port), the fused-vs-sequential conversion bench on the
           experiment's checkpoint, stage 6's wall time with the prefetch on
           and off; ``--ref-pid`` (that exact PID only) gets SIGSTOP before
           them and SIGCONT after, also when a bench fails

Each bench runs as ``python -m cyclevae_tpu_torch.tools.<name> ... --device
D`` in a session of its own, its stdout and stderr in ``--log-dir``.  A
bench that exits non-zero or outlives its limit (the group is stopped; rc
124) writes no artifact.  Where a bench has an artifact, the last line of
its stdout must parse as JSON; only then is it written to ``--out-dir``.
The battery goes on to the next bench after a failure, and exits 1 if any
bench failed (the JAX script exits 0).

    python -m cyclevae_tpu_torch.tools.bench_battery infer [--ref-pid PID] [--out-dir .]
    python -m cyclevae_tpu_torch.tools.bench_battery quiet --work W --wav-root R
        [--config W/flagship_config.json] [--decode-epoch E] [--conf-dir C] [--n-jobs N]
        [--ref-pid PID] [--out-dir .] [--log-dir D] [--wait-s S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional

from ._common import REPO, add_device_arg, decode_epoch, device_entry, resolve_device

PROBE = "import sys, torch; print(float(torch.ones(8, device=sys.argv[1]).sum()))"
PROBE_TIMEOUT_S = 90
PROBE_EVERY_S = 300


class Bench(NamedTuple):
    name: str
    timeout: int                  # seconds
    artifact: Optional[str]       # file name in --out-dir, or None: the bench writes its own
    cmd: List[str]


def benches(phase: str, args, device: str, log_dir: str) -> List[Bench]:
    """The phase's benches, in order, with the JAX battery's time limits."""
    def tool(name, *argv):
        return [sys.executable, "-m", f"cyclevae_tpu_torch.tools.{name}", *argv,
                "--device", device]

    def out(artifact):
        return os.path.join(args.out_dir, artifact)

    def log(name):
        return os.path.join(log_dir, f"{name}.json")

    if phase == "infer":
        return [
            Bench("bench_hmc_chains", 5400, None, tool(
                "bench_hmc_chains", "--adapt-mass", "both", "--mode", "both",
                "--out", out("BENCH_TORCH_HMC_CHAINS.json"))),
            Bench("bench_nuts", 5400, None, tool(
                "bench_nuts", "--chains", "64", "128", "--max-depths", "6", "8", "10",
                "--out", out("BENCH_TORCH_NUTS.json"))),
            Bench("bench_smc_particles", 3600, None, tool(
                "bench_smc_particles", "--out", out("BENCH_TORCH_SMC_PARTICLES.json"))),
            Bench("bench_hmc_trajlen", 3600, None, tool(
                "bench_hmc_trajlen", "--out", out("BENCH_TORCH_HMC_TRAJLEN.json"))),
        ]
    from ..utils.config import load_config
    expdir = os.path.join(args.work, "exp", load_config(args.config).name())
    epoch = decode_epoch(expdir, args.decode_epoch)
    stage6 = ["--work", args.work, "--wav-root", args.wav_root, "--config", args.config,
              "--decode-epoch", str(epoch)]
    if args.conf_dir:
        stage6 += ["--conf-dir", args.conf_dir]
    if args.n_jobs is not None:
        stage6 += ["--n-jobs", str(args.n_jobs)]
    return [
        Bench("bench", 2400, "BENCH_TORCH_TRAIN.json", tool("bench", "--out", log("bench"))),
        Bench("bench_step_breakdown", 1800, "BENCH_TORCH_STEP_BREAKDOWN.json", tool(
            "bench_step_breakdown", "64", "--K", "10", "--out", log("bench_step_breakdown"))),
        Bench("bench_decode_fusion", 1200, "BENCH_TORCH_DECODE_FUSION.json", tool(
            "bench_decode_fusion", os.path.join(expdir, f"checkpoint-{epoch}.pkl"),
            os.path.join(expdir, "model.json"), "--out", log("bench_decode_fusion"))),
        Bench("bench_stage6_wall", 2400, "BENCH_TORCH_STAGE6_WALL.json", tool(
            "bench_stage6_wall", *stage6, "--out", log("bench_stage6_wall"))),
    ]


def _group_alive(pgid: int) -> bool:
    """Whether a process of group ``pgid`` is running (not a zombie)."""
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, _, pgrp = f.read().rsplit(")", 1)[1].split()[:3]
        except OSError:             # ended while being read
            continue
        if int(pgrp) == pgid and state != "Z":
            return True
    return False


def _stop_group(proc: subprocess.Popen) -> None:
    """Stop every process left in the bench's session (the bench itself
    after a timeout, or what it left running): SIGTERM, then SIGKILL after
    10 s; collect the bench."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        proc.poll()
        if not _group_alive(proc.pid):
            break
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            break
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (proc.poll() is None or _group_alive(proc.pid)):
            time.sleep(0.1)
    proc.wait()


def _tail(path: str, n: int) -> str:
    with open(path, errors="replace") as f:
        return "\n".join(f.read().splitlines()[-n:])


def run_bench(bench: Bench, log_dir: str, out_dir: str) -> bool:
    """Run one bench under its limit; True when it exited 0 and, where it
    has an artifact, the last line of its stdout parsed as JSON and was
    written to ``out_dir/<artifact>``."""
    out_log = os.path.join(log_dir, f"{bench.name}.out")
    err_log = os.path.join(log_dir, f"{bench.name}.err")
    print(f"=== {' '.join(bench.cmd)} (timeout {bench.timeout}s)", flush=True)
    with open(out_log, "w") as out, open(err_log, "w") as err:
        proc = subprocess.Popen(bench.cmd, stdout=out, stderr=err, cwd=REPO,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=bench.timeout)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            _stop_group(proc)       # also what the bench left running in its session
    if rc != 0:
        print(f"!!! FAILED rc={rc}: {bench.name} (see {out_log}, {err_log}; "
              f"artifact NOT written)\n{_tail(err_log, 3)}", flush=True)
        return False
    if bench.artifact is None:
        print(_tail(out_log, 2), flush=True)
        return True
    last = _tail(out_log, 1)
    try:
        json.loads(last)
    except ValueError:
        print(f"!!! last line of {out_log} is not JSON; artifact NOT written\n"
              f"{_tail(out_log, 3)}", flush=True)
        return False
    path = os.path.join(out_dir, bench.artifact)
    with open(path, "w") as f:
        f.write(last + "\n")
    print(f"wrote {path}: {last}", flush=True)
    return True


def probe(device: str) -> bool:
    """One tiny op on ``device`` in a process of its own, within 90 s."""
    try:
        return subprocess.run([sys.executable, "-c", PROBE, device], capture_output=True,
                              timeout=PROBE_TIMEOUT_S).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def wait_for_card(device: str, wait_s: float) -> None:
    """Probe every 300 s until the card answers; raise after ``wait_s``."""
    deadline = time.monotonic() + wait_s
    print(f"{time.strftime('%H:%M:%S', time.gmtime())} waiting for the card...", flush=True)
    while not probe(device):
        if time.monotonic() + PROBE_EVERY_S > deadline:
            raise RuntimeError(f"bench_battery: {device} did not answer within {wait_s} s")
        time.sleep(PROBE_EVERY_S)
    print(f"{time.strftime('%H:%M:%S', time.gmtime())} the card answered", flush=True)


def _signal_ref(pid: Optional[int], sig: int, what: str) -> None:
    if pid is None:
        return
    try:
        os.kill(pid, sig)
    except ProcessLookupError:
        return
    print(f"{what} ref trainer {pid}", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=["infer", "quiet"])
    ap.add_argument("--ref-pid", type=int, default=None,
                    help="a CPU job paused (SIGSTOP, that PID only) around the quiet phase")
    ap.add_argument("--out-dir", default=".", help="where the artifacts are written")
    ap.add_argument("--log-dir", default=None,
                    help="each bench's stdout and stderr (default: a new temporary directory)")
    ap.add_argument("--wait-s", type=float, default=0,
                    help="seconds to keep probing the card before giving up")
    ap.add_argument("--work", default=None, help="quiet: the recipe's work directory")
    ap.add_argument("--wav-root", default=None, help="quiet: the wav corpus")
    ap.add_argument("--config", default=None, help="quiet: defaults to <work>/flagship_config.json")
    ap.add_argument("--decode-epoch", type=int, default=None,
                    help="quiet: default the best epoch of history.json")
    ap.add_argument("--conf-dir", default=None, help="quiet: dir with <spk>.f0/<spk>.pow")
    ap.add_argument("--n-jobs", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.phase == "quiet" and not (args.work and args.wav_root):
        ap.error("the quiet phase needs --work and --wav-root")
    dev = resolve_device(args.device)
    for name in ("out_dir", "work", "wav_root", "config", "conf_dir"):
        if getattr(args, name):
            setattr(args, name, os.path.abspath(getattr(args, name)))
    if args.phase == "quiet" and not args.config:
        args.config = os.path.join(args.work, "flagship_config.json")
    os.makedirs(args.out_dir, exist_ok=True)
    log_dir = os.path.abspath(args.log_dir or tempfile.mkdtemp(prefix="bench_battery_"))
    os.makedirs(log_dir, exist_ok=True)

    if dev.type == "cuda":
        wait_for_card(str(dev), args.wait_s)
    plan = benches(args.phase, args, str(dev), log_dir)
    print(f"phase={args.phase}: {len(plan)} bench(es), logs in {log_dir}", flush=True)
    quiet = args.phase == "quiet"
    results = []
    if quiet:
        _signal_ref(args.ref_pid, signal.SIGSTOP, "paused")
    try:
        for bench in plan:
            t0 = time.perf_counter()
            ok = run_bench(bench, log_dir, args.out_dir)
            results.append({"name": bench.name, "ok": ok, "seconds": time.perf_counter() - t0})
    finally:
        if quiet:
            _signal_ref(args.ref_pid, signal.SIGCONT, "resumed")
    failed = [r["name"] for r in results if not r["ok"]]
    print(f"{time.strftime('%H:%M:%S', time.gmtime())} battery phase={args.phase} done"
          + (f"; FAILED: {', '.join(failed)}" if failed else ""), flush=True)
    summary = {"phase": args.phase, "device": device_entry(dev), "log_dir": log_dir,
               "benches": results, "failed": failed, "ok": not failed}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
