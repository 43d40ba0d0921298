"""K3, the AR-GRU reverse scan (``csrc/gru_ar_bwd.cu``).

Operations and bytes of one call, float32, as ``chip_smoke.py``'s
``gru_ar_bwd_bound_ms`` counts them: 2 T B (out*H + 2*3H*H + 2*3H*out)
operations (the gates recomputed, the cotangents through them); bytes of
each input read once (d_trj, gates_x, y_prev, h_prev, mask, weights, b_hh,
dh_T, dy_T) and each output written once (dgx, dgh, dy_tot, dh0, dy0).
``T`` may be fractional: the mean real frames of the B rows."""

PATTERN = r"gru_ar_bwd_kernel"


def work(B: int, T: float, H: int, out: int):
    wb = 4
    ops = 2 * T * B * (out * H + 2 * 3 * H * H + 2 * 3 * H * out)
    nbytes = (B * T * out * 4 + B * T * (3 * H + out + 2 * H) * wb
              + (out * H + 3 * H * H + 3 * H * out) * wb + 3 * H * 4 + (B * H + B * out) * 4
              + 2 * B * T * 3 * H * wb + B * T * out * 4 + (B * H + B * out) * 4)
    return ops, nbytes


def launches() -> int:
    from cyclevae_tpu_torch.ops.cuda_gru import cuda_gru_ar_bwd
    return cuda_gru_ar_bwd.launches
