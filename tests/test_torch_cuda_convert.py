"""The conversion engine's host path on the card: ``device_decode_pair``
replays the captured CUDA graph of the request's padded length
(``Codec.convert_pair``) and brings its outputs to the host in one copy.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_convert.py -q
"""

import numpy as np
import pytest
import torch

from cyclevae_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_host_path_replays_the_graph_and_waits_once(cuda_device):
    """At the flagship width (hu 1024, 300 draws) and padded lengths 560
    and 1120: after the request that captures a length's graph, a request
    gives bitwise the values of the ``on_device`` path fetched and of
    ``encode_mean`` then ``decode_batch`` on the same generator, float32
    latents and float64 decodes, with one wait on the device, one replay
    and two K1 launches counted (the capturing request four: its run off
    the capture launched K1 twice as well)."""
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    from cyclevae_tpu_torch.pipeline.decode import Codec, _speaker_codes, device_decode_pair
    from cyclevae_tpu_torch.vi.train import CycleVAEConfig, init_cyclevae
    dev = cuda_device
    cfg = CycleVAEConfig()
    codec = Codec(init_cyclevae(torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
                  cfg, n_smpl_dec=300, bucket=560, device=dev)
    rng = np.random.default_rng(2)
    gen = lambda: torch.Generator(device=dev).manual_seed(11)
    for lens, Tp in (((390, 130), 560), ((845, 900), 1120)):
        src, trg = (rng.normal(size=(n, 54)).astype(np.float32) for n in lens)
        before = cuda_gru_ar.launches
        device_decode_pair(codec, gen(), src, trg)            # the capture
        assert Tp in codec._pair_phases and codec._pair_phases[Tp].graph is not None
        assert cuda_gru_ar.launches - before == 4
        before = cuda_gru_ar.launches
        with profiling.recording():
            host = device_decode_pair(codec, gen(), src, trg)
            counts = profiling.counters()
        assert counts == {"device_waits": 1, "codec.pair_replays": 1}
        assert cuda_gru_ar.launches - before == 2
        on_dev = [t.cpu().numpy() for t in device_decode_pair(codec, gen(), src, trg,
                                                              on_device=True)]
        (ls, lt), (zs, zt) = codec.encode_mean(gen(), [src, trg])
        T, Tt = lens
        eager = [ls, lt, *codec.decode_batch([(_speaker_codes(T, cfg.n_spk, 1), zs),
                                              (_speaker_codes(T, cfg.n_spk, 0), zs),
                                              (_speaker_codes(Tt, cfg.n_spk, 1), zt)])]
        assert [h.dtype for h in host] == [np.float32] * 2 + [np.float64] * 3
        assert [h.shape[0] for h in host] == [T, Tt, T, T, Tt]
        for h, d, e in zip(host, on_dev, eager):
            assert np.array_equal(np.asarray(h, np.float32), d)
            assert h.dtype == e.dtype and np.array_equal(h, e)
    assert sorted(codec._pair_phases) == [560, 1120]
