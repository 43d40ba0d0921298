"""cyclevae_tpu_torch — the CycleVAE voice-conversion framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``cyclevae_tpu``, which stays the reference. The
module layout mirrors it so each counterpart is easy to find; this package
imports ``torch`` and never ``jax`` or ``cyclevae_tpu``.

Sub-packages
------------
- ``utils``    : typed configs (a copy of the JAX package's), device choice.
- ``models``   : GRU-VAE nets as plain functions on parameter dicts,
                 parameter init from a ``torch.Generator``, sampling.
- ``ops``      : the plain AR-GRU scan and the CUDA AR-GRU kernel
                 (``csrc/gru_ar.cu``), built with ``nvcc`` at first use.
- ``vi``       : model assembly and the reader of JAX checkpoints.
- ``pipeline`` : the stage-6 conversion engine (``Codec``).
- ``interop``  : JAX parameter pytrees <-> the port's tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
