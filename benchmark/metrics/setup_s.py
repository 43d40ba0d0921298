"""Set-up: process start to the first timed unit (imports, the CUDA
context, the kernels built or loaded, weights and inputs made, every shape
warmed up), in seconds on the host clock."""


def read(w):
    return w.setup_s
