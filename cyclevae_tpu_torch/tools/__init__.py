"""The port's tools: benchmarks, sweeps and evaluations of the JAX package's
``tools/*.py``, ``bench.py`` and ``bench_scaling.py``, each under the same
file name, flags, JSON keys and printed lines, with the port's library in
place of the JAX package's.

Run one as ``python -m cyclevae_tpu_torch.tools.<name> [flags]``; each
``main(argv=None)`` returns the summary it writes.  Every tool runs on the
CUDA card unless given ``--device cpu`` and raises without CUDA
(``utils/device.py``); its JSON names the card (``device``: the name and
power limit ``nvidia-smi`` reports, or ``cpu``).  No tool defaults to a path
outside the repository: corpora and work directories are flags.
"""
