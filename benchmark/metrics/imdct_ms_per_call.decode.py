"""Device milliseconds per decode call in `imdct_bands_exact`: K1 at 256 and
512, the short frames' path (K1 at 64, and the host's wait for their index),
the overlap-add: the program's span `carta1.decode.imdct`, averaged over the
traced calls (`benchmark/spans.py`). Layer: exact decode, ops/qmf_kernels
(K2). Moves decode_fps.

A device ms is the time between the span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it. A host ms
under the profiler includes the profiler's own cost per operation, so it
compares only with other traced runs."""

from benchmark import spans

read = spans.device_ms("decode", "carta1.decode.imdct")
