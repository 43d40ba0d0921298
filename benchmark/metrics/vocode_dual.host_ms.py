"""Host milliseconds of a vocoded request rendered by the dual WaveRNN,
read as ``vocode.host_ms`` reads it (the same reader): the program's
top-level spans, each less the ``fetch`` spans under it, summed over the
window, per request.  None from a program that records no spans."""

from benchmark.harness.core import HERE, load_module

read = load_module(HERE / "metrics" / "vocode.host_ms.py", "bench_metric_vocode.host_ms").read
