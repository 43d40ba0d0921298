"""K1, the AR-GRU forward for inference (``csrc/gru_ar.cu``, kTrain false).

Operations and bytes of one call, float32, as ``chip_smoke.py``'s
``gru_ar_bound_ms`` counts them: the hidden, feedback and output products,
2 T B (3H*H + 3H*out + H*out) operations; bytes of each input read once
(weights, biases, gates, y0, h0) and each output written once (trj, y_T,
h_T).  ``T`` may be fractional: the mean real frames of the B rows, so that
padding is never counted."""

PATTERN = r"gru_ar_kernel(<[^>]*false>|I.*Lb0E)"


def work(B: int, T: float, H: int, out: int):
    wb = 4
    ops = 2 * T * B * (3 * H * H + 3 * H * out + H * out)
    nbytes = ((3 * H * H + 3 * H * out + out * H) * wb + (3 * H + out) * 4
              + B * T * 3 * H * wb + (B * out + B * H) * 4
              + B * T * out * 4 + (B * out + B * H) * 4)
    return ops, nbytes


def launches() -> int:
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar
    return cuda_gru_ar.launches
