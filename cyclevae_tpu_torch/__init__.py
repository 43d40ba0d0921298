"""cyclevae_tpu_torch — the CycleVAE voice-conversion framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``cyclevae_tpu``, which stays the reference. The
module layout mirrors it so each counterpart is easy to find; this package
imports ``torch`` and never ``jax`` or ``cyclevae_tpu``.

Sub-packages
------------
- ``utils``    : typed configs (a copy of the JAX package's), device choice,
                 waveform I/O and FIR filters (a copy), the feature store
                 (``.npz`` files with the HDF5 store's dataset names),
                 a prefetch thread.
- ``models``   : GRU-VAE nets as plain functions on parameter dicts,
                 parameter init from a ``torch.Generator``, sampling, KL
                 terms, the training forward's draws; the WaveRNN vocoder;
                 the VQ helpers and a diagonal GMM.
- ``ops``      : the plain AR-GRU scan and the CUDA AR-GRU kernels
                 (``csrc/gru_ar.cu``: inference and training forward;
                 ``csrc/gru_ar_bwd.cu``: the backward), the autograd
                 Function over them, and the WaveRNN sampler
                 (``csrc/wavernn.cu``), all built with ``nvcc`` at first use.
- ``vi``       : model assembly, the training core (cyclic ELBO, TBPTT
                 train step, Adam), checkpoints (the port's, and JAX's read
                 and resumed without JAX).
- ``pipeline`` : the one-to-one recipe (``recipe.run_stages``, ``python -m
                 cyclevae_tpu_torch``): feature extraction, statistics,
                 converted excitation, training (``run_train``), GV
                 calibration, conversion (``Codec``, ``decode_pair``); and
                 neural-vocoder synthesis (``synthesize_vocoder``); the
                 many-to-many recipe (``recipe_mult``), the speaker
                 classifier and the VQ-CycleVAE trainers.
- ``interop``  : JAX parameter pytrees <-> the port's tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
