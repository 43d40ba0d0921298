"""Train-step time decomposition: forward / +backward / optimizer.

Port of the JAX package's ``tools/bench_step_breakdown.py``: a
where-does-the-time-go split of the flagship train step on the kernel route
with bf16 weights (K2 forward, K3 backward): per-segment forward loss, the
forward and backward (``loss.backward()``), the Adam update alone, and the
full train step (n_segs segments, an update after each).  At the default
B = 64 the fused 2B decoder has 128 rows, past one launch: its K2 and K3
calls run in row blocks (``ops/cuda_gru.py``).  Each part is timed over K
calls between two CUDA events (``perf_counter`` on the host); the JAX
tool's round-trip subtraction has no counterpart.

    python -m cyclevae_tpu_torch.tools.bench_step_breakdown [B] [--device cpu]

Prints one JSON line and writes it to ``--out``
(BENCH_TORCH_STEP_BREAKDOWN.json).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._common import (add_device_arg, device_entry, kernel_launches, launches_since,
                      resolve_device, timed, write_json)

HIDDEN_UNITS = 1024
S, N_SEGS = 80, 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=64, help="utterance batch")
    ap.add_argument("--K", type=int, default=10, help="timed calls per part")
    ap.add_argument("--out", default="BENCH_TORCH_STEP_BREAKDOWN.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, K = args.B, args.K

    from ..models.gru_vae import Draws
    from ..vi.train import (CycleVAEConfig, TrainState, init_cycle_state, init_cyclevae,
                            make_optimizer, make_train_step, segment_loss)

    cfg = CycleVAEConfig(hidden_units=HIDDEN_UNITS, use_pallas=True, compute_dtype="bfloat16")
    T = S * N_SEGS
    rng = np.random.default_rng(0)
    t = np.arange(T)[None, :, None]
    feats = (np.sin(t * 0.05 + np.arange(54)[None, None, :])
             + 0.1 * rng.normal(size=(B, T, 54))).astype(np.float32)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    batch = {"feats": as_t(feats),
             "src_code": as_t(np.tile([1., 0.], (B, T, 1))),
             "trg_code": as_t(np.tile([0., 1.], (B, T, 1))),
             "cv_excit": as_t(feats[..., :4]),
             "flens": np.asarray([T] * B, dtype=np.int32)}
    seg = {k: batch[k][:, :S] for k in ("feats", "src_code", "trg_code", "cv_excit")}
    seg["mask"] = torch.ones((B, S), device=dev)

    params = init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg,
                           np.zeros(54, np.float32), np.ones(54, np.float32), device=dev)
    state = init_cycle_state(cfg, params, B)
    opt = make_optimizer(cfg, lr=1e-4)
    opt_state = opt.init(params)
    leaves = [p for group in opt_state.param_groups for p in group["params"]]
    draws = lambda: Draws(torch.Generator(device=dev).manual_seed(1))

    # 1. forward loss only (one segment)
    def fwd():
        with torch.no_grad():
            return segment_loss(params, cfg, draws(), seg, state)[0]
    before = kernel_launches()
    fwd()
    fwd_launches = launches_since(before)
    t_fwd = timed(fwd, dev, reps=K)

    # 2. forward + backward (one segment)
    def vag():
        opt_state.zero_grad(set_to_none=True)
        loss = segment_loss(params, cfg, draws(), seg, state)[0]
        loss.backward()
        return loss
    before = kernel_launches()
    vag()
    vag_launches = launches_since(before)
    t_vag = timed(vag, dev, reps=K)

    # 3. the Adam update alone, on the gradients of one segment (a copy of
    # the parameters, so the full step below starts from the init)
    grads = [p.grad.detach().clone() for p in leaves]
    adam_leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    adam = torch.optim.Adam(adam_leaves, lr=1e-4)
    for p, g in zip(adam_leaves, grads):
        p.grad = g
    t_adam = timed(adam.step, dev, reps=K)

    # 4. the full train step (n_segs segments, an update after each)
    step = make_train_step(cfg, opt, S, N_SEGS)
    ts = TrainState(params, opt.init(params), torch.Generator(device=dev).manual_seed(1), 0)
    holder = [ts]

    def full_step():
        holder[0], m = step(holder[0], batch)
        return m
    before = kernel_launches()
    loss = float(full_step()["loss"].sum())
    step_launches = launches_since(before)
    t_step = timed(full_step, dev, reps=K, warmup=0)

    frames_seg = B * S
    out = {
        "metric": "train_step_breakdown_us_per_frame",
        "config": f"bf16_pallas_bsu{B}",
        "device": device_entry(dev),
        "fwd_us": round(t_fwd / frames_seg * 1e6, 3),
        "fwd_bwd_us": round(t_vag / frames_seg * 1e6, 3),
        "adam_us": round(t_adam / frames_seg * 1e6, 3),
        "full_step_us": round(t_step / (B * T) * 1e6, 3),
        "bwd_over_fwd": round((t_vag - t_fwd) / t_fwd, 2),
        "frames_per_sec_full_step": round(B * T / t_step, 1),
        "launches": {"fwd": fwd_launches, "fwd_bwd": vag_launches, "full_step": step_launches},
        "finite": bool(np.isfinite(loss)),
    }
    write_json(args.out, out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
