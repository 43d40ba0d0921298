"""Host-side DSP: C++ WORLD/SPTK/DTW capability classes + tensor versions.

The port's copy of ``cyclevae_tpu/dsp``. The reference depends on four
compiled pip packages (pyworld, pysptk, dtw_c, mlpg_c); here the same
capability surface is one C++ library, a verbatim copy of the JAX package's
sources in ``native/``, built with ``make`` at first use into the git-ignored
``cyclevae_tpu_torch/build/dsp/`` and bound with ctypes (``_lib``), plus
PyTorch versions of the frame-parallel transforms in :mod:`.torch_ops`.
The wrappers take and return numpy arrays on the host.

``mlpg_c`` note: the reference lists it in tools/requirements.txt:10 but never
imports it (dormant); :mod:`.mlpg` implements it off the conversion path.
"""

from . import dtw, sptk, world  # noqa: F401
