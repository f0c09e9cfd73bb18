"""Device milliseconds per encode call in the block modes (the `rfft` features
in the batched engine, K6's spectra and `transient_score` in the exact one):
the program's span `carta1.encode.transient`, averaged over the traced calls
(`benchmark/spans.py`). Layer: encoder analysis. Moves encode_fps.

A device ms is the time between the span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it. A host ms
under the profiler includes the profiler's own cost per operation, so it
compares only with other traced runs."""

from benchmark import spans

read = spans.device_ms("encode", "carta1.encode.transient")
