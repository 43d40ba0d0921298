"""The dual instantiation of K4 (``csrc/wavernn.cu`` ``wavernn_kernel_dual``,
the published WaveRNN's coarse and fine softmax over 16-bit audio).

Operations and bytes of T samples of B rows, counted as ``kernels/K4.py``
counts the single softmax's: 2 T B (3H*H + 2 Hh*Hh + 2 K*Hh) operations (the
recurrent product of both halves, then each head's two layers over its half,
Hh = H/2); bytes of the conditioning gates read once, the weights (the
masked input weights, Whh, b_hh, O1..O4 and their biases) read once and the
samples written once."""


def work(B: int, T: float, H: int, K: int):
    Hh = H // 2
    ops = 2 * T * B * (3 * H * H + 2 * Hh * Hh + 2 * K * Hh)
    weights = 3 * H * 3 + 3 * H * H + 3 * H + 2 * (Hh * Hh + Hh + K * Hh + K)
    nbytes = T * B * 3 * H * 4 + weights * 4 + T * B * 4
    return ops, nbytes
