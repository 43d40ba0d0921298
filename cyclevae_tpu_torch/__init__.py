"""cyclevae_tpu_torch — the CycleVAE voice-conversion framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``cyclevae_tpu``, which stays the reference. The
module layout mirrors it so each counterpart is easy to find; this package
imports ``torch`` and never ``jax`` or ``cyclevae_tpu``.

Sub-packages
------------
- ``utils``    : typed configs (a copy of the JAX package's), device choice,
                 waveform I/O and FIR filters (a copy).
- ``models``   : GRU-VAE nets as plain functions on parameter dicts,
                 parameter init from a ``torch.Generator``, sampling, KL
                 terms, the training forward's draws; the WaveRNN vocoder.
- ``ops``      : the plain AR-GRU scan and the CUDA AR-GRU kernels
                 (``csrc/gru_ar.cu``: inference and training forward;
                 ``csrc/gru_ar_bwd.cu``: the backward), the autograd
                 Function over them, and the WaveRNN sampler
                 (``csrc/wavernn.cu``), all built with ``nvcc`` at first use.
- ``vi``       : model assembly, the training core (cyclic ELBO, TBPTT
                 train step, Adam), checkpoints (the port's, and JAX's read
                 without JAX).
- ``pipeline`` : the stage-6 conversion engine (``Codec``), batching, the
                 train stage's helpers, the F0 helpers of stage 1, and
                 neural-vocoder synthesis (``synthesize_vocoder``).
- ``interop``  : JAX parameter pytrees <-> the port's tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
