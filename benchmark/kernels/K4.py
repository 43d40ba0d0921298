"""K4, the WaveRNN sampler (``csrc/wavernn.cu``).

Operations and bytes of one call as ``chip_smoke.py``'s ``wavernn_bound_ms``
counts them: 2 T B (3H*H + H*FC + FC*K) operations; bytes of the
conditioning gates read once, the weights (gate table, Whh, b_hh, W1, b1,
W2, b2) read once and the indices written once."""

PATTERN = r"wavernn_kernel"


def work(B: int, T: float, H: int, K: int, FC: int):
    ops = 2 * T * B * (H * 3 * H + H * FC + FC * K)
    nbytes = (T * B * 3 * H * 4 + (K * 3 * H + 3 * H * H + 3 * H + FC * H + FC + K * FC + K) * 4
              + T * B * 4)
    return ops, nbytes


def launches() -> int:
    from cyclevae_tpu_torch.ops.cuda_wavernn import cuda_wavernn_generate
    return cuda_wavernn_generate.launches
