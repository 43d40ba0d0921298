"""What the benchmark may import, by top-level module name compared whole:
no module under ``benchmark/`` imports jax, jaxlib, flax or the JAX package
(``cyclevae_tpu``; the port ``cyclevae_tpu_torch`` is another name), and the
plain reference imports nothing of the port.  Then every mix's driver runs
once at a tiny size on the CPU through the harness (the kernels' plain
versions); the run on the card is the marked test at the end."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.tests._small import CELLS, LISTED, cell_entry, run_small

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cyclevae_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert "cyclevae_tpu_torch" not in names
    assert not {"benchmark"} & names or all(
        n.startswith("benchmark.reference") for n in _from_modules(path))


def _from_modules(path):
    tree = ast.parse(path.read_text())
    return [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]


def test_the_import_check_sees_a_forbidden_name(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom cyclevae_tpu.ops import x\n"
                 "from cyclevae_tpu_torch import y\n")
    assert set(_imports(f)) == {"jax", "cyclevae_tpu", "cyclevae_tpu_torch"}


def test_no_jax_module_is_loaded_after_a_run():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark.tests._small import run_small\n"
            "r = run_small('o2o-convert')\n"
            "from benchmark.harness.core import forbidden_modules\n"
            "print(json.dumps(forbidden_modules()))\n") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


LISTED_CELLS = [w["name"] for w in LISTED["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_every_cell_runs_on_the_cpu(cell, trace):
    r = run_small(cell, trace=trace)
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    entry = cell_entry(cell)
    want = entry.per_layer if trace else entry.end_to_end
    # a CPU run reads no device trace: those per-layer metrics are left out
    device_only = {m["name"] for m in want if m["source"] == "device_trace"}
    assert {m["name"] for m in want} - device_only <= set(r["metrics"]) | {
        m["name"] for m in want if m["name"].endswith("device_idle_pct")}
    assert list(r)[-1] == "compared"


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", LISTED_CELLS[0],
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=120,
                         cwd=str(BENCH.parent), env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED_CELLS)
def test_cell_on_the_card(cell):
    """On the card: one short run of the cell through its command."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3"], capture_output=True, text=True,
                         timeout=1200, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
