"""The port reads a real JAX checkpoint (params + optax state) in a process
where ``jax``, ``optax`` and ``cyclevae_tpu`` cannot be imported."""

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
