"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W power limit): what every roofline and mfu share
divides by.  The cells run float32 with TF32 off, so the float32 rate
outside the tensor cores is the compute peak."""

F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = F32_FLOPS) -> float:
    """The least time the work could take: operations over the compute peak
    or bytes over the memory bandwidth, whichever is longer."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
