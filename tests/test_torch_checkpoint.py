"""The port reads a real JAX checkpoint (params + optax state) in a process
where ``jax``, ``optax`` and ``cyclevae_tpu`` cannot be imported, and
restores a training state from it there."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import jax

from cyclevae_tpu.vi.checkpoint import save_checkpoint
from cyclevae_tpu.vi.train import CycleVAEConfig, init_cyclevae, make_optimizer

ROOT = Path(__file__).resolve().parent.parent

READER = """
import sys
for m in ("jax", "jaxlib", "optax", "cyclevae_tpu"):
    sys.modules[m] = None
import numpy as np
from cyclevae_tpu_torch.interop import params_from_jax
from cyclevae_tpu_torch.vi.checkpoint import latest_checkpoint, load_checkpoint
from cyclevae_tpu_torch.vi.train import CycleVAEParams

ckpt_dir, want_path = sys.argv[1], sys.argv[2]
path = latest_checkpoint(ckpt_dir)
assert path.endswith("checkpoint-7.pkl"), path
ckpt = load_checkpoint(path)
assert ckpt["epoch"] == 7 and isinstance(ckpt["params"], CycleVAEParams)
params = params_from_jax(ckpt["params"], device="cpu")
leaves = []
def walk(t):
    if isinstance(t, dict):
        for k in sorted(t):
            walk(t[k])
    elif isinstance(t, (list, tuple)):
        for v in t:
            walk(v)
    else:
        leaves.append(t.numpy())
walk([params.encoder, params.decoder])
want = np.load(want_path)
assert len(leaves) == len(want.files), (len(leaves), len(want.files))
for i, leaf in enumerate(leaves):
    np.testing.assert_array_equal(leaf, want[f"a{i}"])
from cyclevae_tpu_torch.vi.checkpoint import restore_train_state
from cyclevae_tpu_torch.vi.train import CycleVAEConfig, make_optimizer, trainable_leaves
ts = restore_train_state(ckpt, make_optimizer(CycleVAEConfig(hidden_units=16)), device="cpu")
state = ts.opt_state.state_dict()["state"]
assert len(state) == len(trainable_leaves(ts.params))
assert all(float(s["step"]) == 0.0 and not s["exp_avg"].any() for s in state.values())
print("ok", len(leaves))
"""


def test_reads_jax_checkpoint_without_jax(tmp_path):
    cfg = CycleVAEConfig(hidden_units=16)
    params = init_cyclevae(jax.random.PRNGKey(0), cfg,
                           np.arange(54, dtype=np.float32), np.ones(54, np.float32))
    opt_state = make_optimizer(cfg).init(params)
    ckpt_dir = tmp_path / "ckpt"
    for epoch in (3, 7):
        save_checkpoint(str(ckpt_dir), params, opt_state, jax.random.PRNGKey(1),
                        np.random.default_rng(0), epoch)
    # the params' leaves, dict keys sorted, lists in order
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(np.asarray(t))
    walk([params.encoder, params.decoder])
    np.savez(tmp_path / "want.npz", **{f"a{i}": a for i, a in enumerate(leaves)})

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", READER, str(ckpt_dir),
                          str(tmp_path / "want.npz")],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok", str(len(leaves))]


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    """The port's own training state (params, Adam state after a step, the
    torch generator, the numpy generator, the epoch) saves and restores
    exactly, atomically, and training resumes on the same trajectory."""
    import torch

    from cyclevae_tpu_torch.vi import train as ttrain
    from cyclevae_tpu_torch.vi.checkpoint import (latest_checkpoint, load_checkpoint,
                                                  restore_np_rng, restore_train_state,
                                                  save_checkpoint)

    cfg = ttrain.CycleVAEConfig(hidden_units=8, lat_dim=4, use_pallas=True)
    rng = np.random.default_rng(0)
    params = ttrain.init_cyclevae(torch.Generator().manual_seed(0), cfg,
                                  rng.normal(size=54), 0.5 + rng.random(54), device="cpu")
    opt = ttrain.make_optimizer(cfg, lr=1e-3)
    ts = ttrain.TrainState(params, opt.init(params), torch.Generator().manual_seed(1), 0)
    T = 20
    batch = {"feats": rng.normal(size=(2, T, 54)).astype(np.float32),
             "src_code": np.tile([1.0, 0.0], (2, T, 1)).astype(np.float32),
             "trg_code": np.tile([0.0, 1.0], (2, T, 1)).astype(np.float32),
             "cv_excit": rng.normal(size=(2, T, 4)).astype(np.float32),
             "flens": np.array([T, 13], np.int32)}
    step = ttrain.make_train_step(cfg, opt, 10, 2)
    ts, _ = step(ts, batch)
    np_rng = np.random.default_rng(3)
    np_rng.random(5)
    path = save_checkpoint(str(tmp_path), ts.params, ts.opt_state, ts.rng, np_rng, 4)
    assert path.endswith("checkpoint-4.pkl") and latest_checkpoint(str(tmp_path)) == path
    assert not os.path.exists(path + ".tmp")

    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 4
    back = restore_train_state(ckpt, opt, device="cpu")
    flat = lambda p: [t for net in p for t in ttrain._leaves(net)]
    for a, b in zip(flat(back.params), flat(ts.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    sa, sb = back.opt_state.state_dict(), ts.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sb["state"]:
        for k in sb["state"][i]:
            torch.testing.assert_close(sa["state"][i][k], sb["state"][i][k], atol=0, rtol=0)
    assert restore_np_rng(ckpt["np_rng_state"]).random() == np_rng.random()

    # both resume on the same trajectory: the generator's draws included
    ts1, m1 = step(ts, batch)
    ts2, m2 = step(back, batch)
    torch.testing.assert_close(m1["loss"], m2["loss"], atol=0, rtol=0)
    for a, b in zip(flat(ts1.params), flat(ts2.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
