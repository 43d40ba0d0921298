"""The AR-GRU wrappers' row blocks (``ops/cuda_gru.py``): a batch larger than
one launch takes runs as consecutive row blocks of at most ``max_batch``
rows, one counted launch each, and the result is the one-call function.

Runs on the CPU through the wrappers' seams: ``_on_card`` says yes, the
launch limit is set to 3 rows, the library loader is a stand-in, and each
block's launch (``launch_rows`` / ``launch_bwd_rows``) runs the kernel's
plain version on the block's rows.  ``max_batch`` itself is held against a
stand-in C plan that answers "rows do not fit" past a known limit.
"""

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.ops import _build, cuda_gru
from cyclevae_tpu_torch.ops.gru_ar_vjp import gru_ar_fused

torch.set_num_threads(1)

H, OUT, T, LIMIT = 8, 3, 5, 3
WRAPPERS = (cuda_gru.cuda_gru_ar, cuda_gru.cuda_gru_ar_train, cuda_gru.cuda_gru_ar_bwd)


def _problem(B, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda scale, *s: torch.tensor((scale * rng.normal(size=s)).astype(np.float32))
    a = 1.0 / np.sqrt(H)
    layer = {"w_ih": f(a, 3 * H, 4 + OUT), "w_hh": f(a, 3 * H, H), "b_hh": f(0.1, 3 * H)}
    proj = {"w": f(a, OUT, H), "b": f(0.1, OUT)}
    mask = torch.tensor(((rng.random((B, T, H)) < 0.7) / 0.7).astype(np.float32))
    return layer, proj, f(0.5, B, T, 3 * H), f(0.1, B, OUT), f(0.1, B, H), mask


@pytest.fixture
def blocks(monkeypatch):
    """Every wrapper takes the card's route on CPU tensors, with a limit of
    LIMIT rows a launch; each block runs the plain version.  Yields the
    rows of every block launch, as (kernel, B)."""
    seen = []

    def rows_k12(lib, weights, gates_x, y0, h0, wdt, out_mask=None):
        assert lib == "stub" and gates_x.shape[0] <= LIMIT
        wy, whh, bhh, wout, bout = weights
        layer, proj = {"w_ih": wy, "w_hh": whh, "b_hh": bhh}, {"w": wout, "b": bout}
        seen.append(("k2" if out_mask is not None else "k1", gates_x.shape[0]))
        if out_mask is None:
            return cuda_gru.gru_ar_reference(layer, proj, gates_x, y0, h0, wdt)
        return cuda_gru.gru_ar_train_reference(layer, proj, gates_x, y0, h0, out_mask, wdt)

    def rows_k3(lib, *args):
        assert lib == "stub" and args[4].shape[0] <= LIMIT
        seen.append(("k3", args[4].shape[0]))
        return cuda_gru.gru_ar_bwd_reference(*args)

    monkeypatch.setattr(cuda_gru, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_gru, "max_batch", lambda *a, **k: LIMIT)
    monkeypatch.setattr(_build, "load", lambda name: "stub")
    monkeypatch.setattr(cuda_gru, "launch_rows", rows_k12)
    monkeypatch.setattr(cuda_gru, "launch_bwd_rows", rows_k3)
    before = [w.launches for w in WRAPPERS]
    yield seen
    for w, b in zip(WRAPPERS, before):
        w.launches = b


def _counted(fn):
    before = [w.launches for w in WRAPPERS]
    out = fn()
    return out, [w.launches - b for w, b in zip(WRAPPERS, before)]


def _same(got, want, what):
    """float32 within 1e-6; returns whether every output is bitwise equal."""
    bitwise = True
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), atol=1e-6, rtol=0,
                                   err_msg=what)
        bitwise &= bool(torch.equal(g, w))
    return bitwise


@pytest.mark.parametrize("B, n_blocks", [(7, 3), (3, 1)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_kernels_in_row_blocks(blocks, B, n_blocks, wdt):
    layer, proj, gx, y0, h0, mask = _problem(B)
    got, n = _counted(lambda: cuda_gru.cuda_gru_ar(layer, proj, gx, y0, h0, wdt))
    want = cuda_gru.gru_ar_reference(layer, proj, gx, y0, h0, wdt)
    # each row's recurrence is its own: the blocks give the one-call values
    _same(got, want, "K1")
    assert n == [n_blocks, 0, 0]
    got, n = _counted(lambda: cuda_gru.cuda_gru_ar_train(layer, proj, gx, y0, h0, mask, wdt))
    want = cuda_gru.gru_ar_train_reference(layer, proj, gx, y0, h0, mask, wdt)
    _same(got, want, "K2")
    assert got[3].dtype == wdt          # h_seq stays at the weight dtype
    assert n == [0, n_blocks, 0]
    sizes = [LIMIT] * (B // LIMIT) + ([B % LIMIT] if B % LIMIT else [])
    assert blocks == [("k1", b) for b in sizes] + [("k2", b) for b in sizes]


@pytest.mark.parametrize("B, n_blocks", [(7, 3), (3, 1)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_in_row_blocks(blocks, B, n_blocks, wdt):
    layer, proj, gx, y0, h0, mask = _problem(B, seed=1)
    rng = np.random.default_rng(2)
    trj, _, _, h_seq = cuda_gru.gru_ar_train_reference(layer, proj, gx, y0, h0, mask, wdt)
    args = (proj["w"].to(wdt), layer["w_hh"].to(wdt), layer["w_ih"][:, -OUT:].to(wdt),
            layer["b_hh"], torch.tensor(rng.normal(size=(B, T, OUT)).astype(np.float32)), gx,
            torch.cat([y0[:, None], trj[:, :-1]], dim=1).to(wdt),
            torch.cat([h0[:, None].to(wdt), h_seq[:, :-1]], dim=1), mask,
            torch.tensor(rng.normal(size=(B, H)).astype(np.float32)),
            torch.tensor(rng.normal(size=(B, OUT)).astype(np.float32)))
    got, n = _counted(lambda: cuda_gru.cuda_gru_ar_bwd(*args))
    want = cuda_gru.gru_ar_bwd_reference(*args)
    _same(got, want, "K3")
    assert [g.dtype for g in got] == [wdt, wdt] + [torch.float32] * 3
    assert n == [0, 0, n_blocks]


@pytest.mark.parametrize("B, n_blocks", [(7, 3), (3, 1)])
def test_fused_gradient_in_row_blocks(blocks, B, n_blocks):
    """``gru_ar_fused`` over blocked K2 and K3: values and every gradient as
    the one-call plain versions give them; the weight gradients' einsums run
    once over all rows."""
    layer, proj, gx, y0, h0, mask = _problem(B, seed=3)
    base = [layer["w_ih"][:, -OUT:], layer["w_hh"], layer["b_hh"], proj["w"], proj["b"],
            gx, y0, h0, mask]

    def run(on_card):
        cuda_gru._on_card = lambda t: on_card
        leaves = [t.clone().requires_grad_(True) for t in base]
        trj, y_T, h_T = gru_ar_fused(*leaves)
        (torch.sum(trj ** 2) + torch.sum(torch.sin(y_T)) + torch.sum(h_T ** 2)).backward()
        return [trj, y_T, h_T], [t.grad for t in leaves]

    (vals, grads), n = _counted(lambda: run(True))
    want_vals, want_grads = run(False)
    assert n == [0, n_blocks, n_blocks]
    _same([v.detach() for v in vals], [v.detach() for v in want_vals], "values")
    _same(grads, want_grads, "gradients")


class _StubLib:
    """A stand-in C library whose plans fit up to ``fit`` rows and answer
    ``cudaErrorInvalidConfiguration`` past them, or ``other`` at ``bad``."""

    def __init__(self, fit, bad=None, other=2):
        self.fit, self.bad, self.other, self.asked = fit, bad, other, []
        for name in ("gru_ar_plan_f32", "gru_ar_train_plan_bf16", "gru_ar_bwd_plan_f32"):
            # a function object, which takes the argtypes the wrapper sets
            setattr(self, name, lambda *a: self._plan(*a))

    def _plan(self, batch, hidden, out_dim, *outs):
        self.asked.append(batch)
        if batch == self.bad:
            return self.other
        return 0 if batch <= self.fit else 9

    def cuda_error_string(self, err):
        return b"stub error"


@pytest.fixture
def fresh(monkeypatch):
    for name in ("_PLANS", "_MAX_BATCH", "_ENTRIES"):
        monkeypatch.setattr(cuda_gru, name, {})

    def use(lib):
        monkeypatch.setattr(_build, "load", lambda name: lib)
        return lib
    return use


@pytest.mark.parametrize("kind, wdt, fit", [("k1", torch.float32, 46), ("k2", torch.bfloat16, 82),
                                            ("k3", torch.float32, 51), ("k1", torch.float32, 1),
                                            ("k3", torch.float32, 4096)])
def test_max_batch_bisects_to_the_plans_limit(fresh, kind, wdt, fit):
    lib = fresh(_StubLib(fit))
    assert cuda_gru.max_batch(kind, 1024, 50, wdt, device=0) == fit
    asked = len(lib.asked)
    assert asked <= 2 * 13
    # cached per key: asked again, no plan is made
    assert cuda_gru.max_batch(kind, 1024, 50, wdt, device=0) == fit
    assert len(lib.asked) == asked


def test_max_batch_is_zero_when_no_row_fits(fresh):
    fresh(_StubLib(0))
    assert cuda_gru.max_batch("k2", 1024, 50, torch.bfloat16, device=0) == 0


def test_max_batch_is_per_out_dim(fresh):
    """The encoder's out = 64 and the decoder's out = 50 have limits of
    their own."""
    lib = fresh(_StubLib(46))
    assert cuda_gru.max_batch("k1", 1024, 50, torch.float32, device=0) == 46
    lib.fit = 40
    assert cuda_gru.max_batch("k1", 1024, 64, torch.float32, device=0) == 40
    assert cuda_gru.max_batch("k1", 1024, 50, torch.float32, device=0) == 46


@pytest.mark.parametrize("other", [2, 700, 719])
def test_other_plan_errors_propagate(fresh, other):
    """Only "rows do not fit" means not fitting: an out-of-memory, an
    illegal address or a launch failure while planning raises."""
    fresh(_StubLib(46, bad=32, other=other))
    with pytest.raises(RuntimeError, match="stub error") as info:
        cuda_gru.max_batch("k1", 1024, 50, torch.float32, device=0)
    assert not isinstance(info.value, cuda_gru.RowsDoNotFit)


def test_rows_do_not_fit_is_a_runtime_error(fresh):
    fresh(_StubLib(46))
    with pytest.raises(cuda_gru.RowsDoNotFit, match="do not fit"):
        cuda_gru.plan(_build.load("gru_ar"), 47, 1024, 50, torch.float32, device=0)
    assert issubclass(cuda_gru.RowsDoNotFit, RuntimeError)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="kind"):
        cuda_gru.max_batch("k4", 1024, 50, torch.float32, device=0)

