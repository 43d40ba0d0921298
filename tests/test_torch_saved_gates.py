"""The training path's saved gates (``ops/cuda_gru.py``, ``ops/gru_ar_vjp.py``)
on the CPU: the plain forward returns the gates r, z, n and gh_n of every
frame, and the plain K3 reads them where they are given and recomputes them
where not.  The card's route is taken through the wrappers' seams
(``_on_card`` says yes, the library loader and the per-block launches are
stand-ins that run the plain versions): K2's launches hand their gates to
K3's, each K3 launch counts which it did (``gru_bwd.gates_saved`` /
``gru_bwd.gates_recomputed``), and gates of the wrong shape or dtype raise
before any launch."""

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.ops import _build, cuda_gru, gru_ar_vjp
from cyclevae_tpu_torch.ops.gru_ar_vjp import gru_ar_fused
from cyclevae_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, OUT, CONV = 12, 5, 4
WDTS = pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
SAVED, RECOMPUTED = "gru_bwd.gates_saved", "gru_bwd.gates_recomputed"


def _problem(B, T, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda scale, *s: torch.tensor((scale * rng.normal(size=s)).astype(np.float32))
    a = 1.0 / np.sqrt(H)
    layer = {"w_ih": f(a, 3 * H, CONV + OUT), "w_hh": f(a, 3 * H, H), "b_hh": f(0.1, 3 * H)}
    proj = {"w": f(a, OUT, H), "b": f(0.1, OUT)}
    mask = torch.tensor(((rng.random((B, T, H)) < 0.7) / 0.7).astype(np.float32))
    return layer, proj, f(0.5, B, T, 3 * H), f(0.3, B, OUT), f(0.3, B, H), mask, rng


def _forward_and_bwd_args(B, T, wdt, seed=0):
    """The plain forward with its gates, and K3's inputs as the training
    path builds them from it (``ops/gru_ar_vjp.py``)."""
    layer, proj, gx, y0, h0, mask, rng = _problem(B, T, seed)
    trj, _, _, h_seq, gates = cuda_gru._forward_reference(layer, proj, gx, y0, h0, mask, wdt)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    args = (proj["w"].to(wdt), layer["w_hh"].to(wdt), layer["w_ih"][:, CONV:].to(wdt),
            layer["b_hh"], f(B, T, OUT), gx, torch.cat([y0[:, None], trj[:, :-1]], dim=1).to(wdt),
            torch.cat([h0[:, None].to(wdt), h_seq[:, :-1]], dim=1), mask, f(B, H), f(B, OUT))
    return gates, args


@WDTS
@pytest.mark.parametrize("B,T", [(3, 1), (2, 2), (3, 7)])
def test_forward_gates_are_what_the_backward_recomputes(wdt, B, T):
    gates, args = _forward_and_bwd_args(B, T, wdt)
    assert gates.shape == (B, T, 4, H) and gates.dtype == torch.float32
    wout, whh, wy, bhh, _, gx, y_prev, h_prev = args[:8]
    want = cuda_gru.gru_ar_gates_reference(whh, wy, bhh, gx, y_prev, h_prev)
    # the same operands, rounded where the kernels round them; only the
    # order of the sums differs (one frame at a time, or all frames at once)
    torch.testing.assert_close(gates, want, atol=1e-6, rtol=0)
    # the wrapper on CPU tensors: the plain forward's gates, and trj, y_T,
    # h_T and h_seq as the plain K2
    layer, proj, gx_, y0, h0, mask, _ = _problem(B, T)
    got = cuda_gru.cuda_gru_ar_train_gates(layer, proj, gx_, y0, h0, mask, wdt)
    assert torch.equal(got[4], gates)
    for g, w in zip(got[:4], cuda_gru.gru_ar_train_reference(layer, proj, gx_, y0, h0, mask,
                                                             wdt)):
        assert torch.equal(g, w)


@WDTS
@pytest.mark.parametrize("B,T", [(3, 1), (2, 2), (3, 7)])
def test_backward_on_given_gates_is_the_backward_that_recomputes(wdt, B, T):
    gates, args = _forward_and_bwd_args(B, T, wdt, seed=1)
    recomputed = cuda_gru.gru_ar_bwd_reference(*args)
    wout, whh, wy, bhh, _, gx, y_prev, h_prev = args[:8]
    same = cuda_gru.gru_ar_gates_reference(whh, wy, bhh, gx, y_prev, h_prev)
    # the very gates the recompute forms: the same function, bitwise
    for g, w in zip(cuda_gru.gru_ar_bwd_reference(*args, same), recomputed):
        assert torch.equal(g, w)
    # the forward's gates: within the rounding of the gates' sums
    for g, w in zip(cuda_gru.cuda_gru_ar_bwd(*args, gates=gates), recomputed):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = max(float(w.float().abs().max()), 1.0)
        atol = (1e-5 if wdt == torch.float32 else 2e-2) * scale
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


LIMIT = 3


@pytest.fixture
def card_route(monkeypatch):
    """Every wrapper takes the card's route on CPU tensors, LIMIT rows a
    launch: a K2 launch returns the plain forward's outputs with its gates,
    and each K3 launch is recorded (its rows, whether it was given gates)
    and runs the plain version."""
    seen = []

    def rows_k12(lib, weights, gates_x, y0, h0, wdt, out_mask=None):
        wy, whh, bhh, wout, bout = weights
        outs = cuda_gru._forward_reference({"w_ih": wy, "w_hh": whh, "b_hh": bhh},
                                           {"w": wout, "b": bout}, gates_x, y0, h0, out_mask,
                                           wdt)
        return outs if out_mask is not None else outs[:3]

    def rows_k3(lib, *args):
        seen.append((args[4].shape[0], args[-1] is not None))
        return cuda_gru.gru_ar_bwd_reference(*args)

    monkeypatch.setattr(cuda_gru, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_gru, "max_batch", lambda *a, **k: LIMIT)
    monkeypatch.setattr(_build, "load", lambda name: "stub")
    monkeypatch.setattr(cuda_gru, "launch_rows", rows_k12)
    monkeypatch.setattr(cuda_gru, "launch_bwd_rows", rows_k3)
    before = cuda_gru.cuda_gru_ar_train.launches, cuda_gru.cuda_gru_ar_bwd.launches
    yield seen
    cuda_gru.cuda_gru_ar_train.launches, cuda_gru.cuda_gru_ar_bwd.launches = before
    profiling.reset()


def _sizes(B):
    return [LIMIT] * (B // LIMIT) + ([B % LIMIT] if B % LIMIT else [])


def test_the_plain_version_counts_nothing():
    """Only a launch counts: the plain K3 on CPU tensors is none."""
    gates, args = _forward_and_bwd_args(2, 4, torch.float32)
    with profiling.recording():
        cuda_gru.cuda_gru_ar_bwd(*args, gates=gates)
        cuda_gru.cuda_gru_ar_bwd(*args)
        assert profiling.counters() == {}


@pytest.mark.parametrize("B", [2, 7])
def test_counters_count_one_a_launch_on_each_path(card_route, B):
    gates, args = _forward_and_bwd_args(B, 4, torch.float32)
    n = len(_sizes(B))
    with profiling.recording():
        cuda_gru.cuda_gru_ar_bwd(*args)
        assert profiling.counters() == {RECOMPUTED: n}
        cuda_gru.cuda_gru_ar_bwd(*args, gates=gates)
        assert profiling.counters() == {RECOMPUTED: n, SAVED: n}
    # nothing is counted outside a recording
    cuda_gru.cuda_gru_ar_bwd(*args)
    assert profiling.counters() == {RECOMPUTED: n, SAVED: n}
    assert card_route == ([(b, False) for b in _sizes(B)] + [(b, True) for b in _sizes(B)]
                          + [(b, False) for b in _sizes(B)])


@pytest.mark.parametrize("B", [2, 7])
def test_fused_gradient_reads_the_forward_gates(card_route, monkeypatch, B):
    """``gru_ar_fused`` on the card's route hands K2's gates to K3 row block
    by row block: every K3 launch given its rows' gates and counted as
    saved, and every gradient as the plain path gives it; a forward that
    keeps none has K3 recompute them, counted so."""
    layer, proj, gx, y0, h0, mask, _ = _problem(B, 6, seed=2)
    base = [layer["w_ih"][:, CONV:], layer["w_hh"], layer["b_hh"], proj["w"], proj["b"],
            gx, y0, h0, mask]

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in base]
        trj, y_T, h_T = gru_ar_fused(*leaves)
        (torch.sum(trj ** 2) + torch.sum(torch.sin(y_T)) + torch.sum(h_T ** 2)).backward()
        return [t.grad for t in leaves]

    n = len(_sizes(B))
    with profiling.recording():
        saved = grads()
        assert profiling.counters() == {SAVED: n}
        real = gru_ar_vjp.cuda_gru_ar_train_gates
        monkeypatch.setattr(gru_ar_vjp, "cuda_gru_ar_train_gates",
                            lambda *a: (*real(*a)[:4], None))
        recomputed = grads()
        assert profiling.counters() == {SAVED: n, RECOMPUTED: n}
    assert card_route == [(b, True) for b in _sizes(B)] + [(b, False) for b in _sizes(B)]
    monkeypatch.setattr(cuda_gru, "_on_card", lambda t: False)
    monkeypatch.setattr(gru_ar_vjp, "cuda_gru_ar_train_gates", real)
    plain = grads()
    for a, b, c in zip(saved, recomputed, plain):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=0)
        torch.testing.assert_close(b, c, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bad", ["steps", "gates", "units", "rows", "bf16"])
def test_gates_of_the_wrong_shape_raise_before_any_launch(card_route, bad):
    gates, args = _forward_and_bwd_args(2, 5, torch.float32)
    wrong = {"steps": gates[:, :-1], "gates": gates[:, :, :3], "units": gates[..., :-1],
             "rows": gates[:1], "bf16": gates.to(torch.bfloat16)}[bad]
    before = cuda_gru.cuda_gru_ar_bwd.launches
    with pytest.raises(ValueError, match="gates"):
        cuda_gru.cuda_gru_ar_bwd(*args, gates=wrong)
    assert card_route == [] and cuda_gru.cuda_gru_ar_bwd.launches == before
    # the plain version refuses them too
    with pytest.raises(ValueError, match="gates"):
        cuda_gru.gru_ar_bwd_reference(*args, wrong)
    # the right gates take the route: one launch, the plain values
    got = cuda_gru.cuda_gru_ar_bwd(*args, gates=gates)
    assert card_route == [(2, True)] and cuda_gru.cuda_gru_ar_bwd.launches == before + 1
    for g, w in zip(got, cuda_gru.gru_ar_bwd_reference(*args, gates)):
        assert torch.equal(g, w)
