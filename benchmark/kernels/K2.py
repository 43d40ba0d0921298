"""K2, the AR-GRU forward for training (``csrc/gru_ar.cu``, kTrain true).

Operations and bytes of one call, float32, as ``chip_smoke.py``'s
``gru_ar_train_bound_ms`` counts them: 2 T B (3H*H + 3H*out + H*out)
operations; bytes of each input read once (gates, mask, weights, biases, y0,
h0) and each output written once (trj, y_T, h_T, h_seq).  ``T`` may be
fractional: the mean real frames of the B rows."""

PATTERN = r"gru_ar_kernel(<[^>]*true>|I.*Lb1E)"


def work(B: int, T: float, H: int, out: int):
    wb = 4
    ops = 2 * T * B * (3 * H * H + 3 * H * out + H * out)
    nbytes = (B * T * (3 * H + H) * wb + (3 * H * H + 3 * H * out + out * H) * wb
              + (3 * H + out) * 4 + (B * out + B * H) * 4
              + B * T * out * 4 + (B * out + B * H) * 4 + B * T * H * wb)
    return ops, nbytes


def launches() -> int:
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar_train
    return cuda_gru_ar_train.launches
