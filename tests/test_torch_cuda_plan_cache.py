"""The AR-GRU wrappers make each kernel plan once per shape and device, and
set each C entry point's argument types once (``ops/cuda_gru.py``); the
WaveRNN sampler's plans (``ops/cuda_wavernn.py``, K4 and its dual
instantiation) go through the same cache.

Runs on the CPU: the C plan is replaced by a counter, the library by a
stand-in object.
"""

import ctypes
import types

import pytest
import torch

from cyclevae_tpu_torch.ops import cuda_gru, cuda_wavernn


@pytest.fixture
def queries(monkeypatch):
    """Every C plan query, as (entry, B, H, out, dtype); the cache emptied."""
    seen = []

    def fake_plan(lib, entry, n_out, batch, hidden, out_dim, weight_dtype):
        seen.append((entry, batch, hidden, out_dim, weight_dtype))
        return tuple(range(n_out))

    monkeypatch.setattr(cuda_gru, "_plan", fake_plan)
    monkeypatch.setattr(cuda_gru, "_PLANS", {})
    return seen


LIB = object()


def test_repeated_plans_of_one_key_query_once(queries):
    for _ in range(3):
        assert cuda_gru.plan(LIB, 10, 1024, 50, torch.float32, train=True, device=0) == \
            (0, 1, 2, 3, 4)
        assert cuda_gru.plan_bwd(LIB, 10, 1024, 50, torch.float32, device=0) == (0, 1, 2, 3)
    assert queries == [("gru_ar_train_plan", 10, 1024, 50, torch.float32),
                       ("gru_ar_bwd_plan", 10, 1024, 50, torch.float32)]


@pytest.mark.parametrize("change", ["batch", "hidden", "out", "dtype", "train", "device"])
def test_a_new_key_queries_again(queries, change):
    key = dict(batch=5, hidden=1024, out=64, dtype=torch.float32, train=False, device=0)
    call = lambda k: cuda_gru.plan(LIB, k["batch"], k["hidden"], k["out"], k["dtype"],
                                   train=k["train"], device=k["device"])
    call(key)
    call(key)
    new = {"batch": 10, "hidden": 1030, "out": 50, "dtype": torch.bfloat16, "train": True,
           "device": 1}
    other = dict(key, **{change: new[change]})
    call(other)
    call(other)
    call(key)
    assert len(queries) == 2


@pytest.mark.parametrize("dual", [False, True], ids=["mulaw", "dual"])
def test_wavernn_plans_are_made_once_per_shape_in_the_same_cache(queries, monkeypatch, dual):
    """What each K4 launch asks (``launch`` calls ``plan``): one query for
    repeated launches of one shape, one more for a new B or a new library."""
    seen = []

    def fake_plan(lib, entry, batch, hidden, n_classes, fc_dim):
        seen.append((lib, entry, batch))
        return (8, 8, 4, 16, 1024)

    monkeypatch.setattr(cuda_wavernn, "_plan", fake_plan)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    fc, entry = (0, "wavernn_dual_plan") if dual else (128, "wavernn_plan")
    other = object()
    for _ in range(3):
        for lib, B in ((LIB, 1), (LIB, 4), (other, 1)):
            assert cuda_wavernn.plan(lib, B, 896, 256, fc, dual=dual) == (8, 8, 4, 16, 1024)
    assert seen == [(LIB, entry, 1), (LIB, entry, 4), (other, entry, 1)]
    assert len(cuda_gru._PLANS) == 3 and queries == []


def test_entry_points_get_their_argument_types_once():
    lookups = []

    class Lib:
        def __getattr__(self, name):
            lookups.append(name)
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    types_ = [ctypes.c_void_p, ctypes.c_int]
    first = cuda_gru._entry(lib, "gru_ar_f32", types_)
    again = cuda_gru._entry(lib, "gru_ar_f32", types_)
    assert first is again and lookups == ["gru_ar_f32"]
    assert first.argtypes == types_ and first.restype is ctypes.c_int
    cuda_gru._entry(lib, "gru_ar_bf16", types_)
    assert lookups == ["gru_ar_f32", "gru_ar_bf16"]
