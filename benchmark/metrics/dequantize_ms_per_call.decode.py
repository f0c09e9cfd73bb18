"""Device milliseconds per decode call in `dequantize_exact` and
`scatter_bfus`: the program's span `carta1.decode.dequantize`, averaged over
the traced calls (`benchmark/spans.py`). Layer: exact decode,
ops/qmf_kernels (K2). Moves decode_fps.

A device ms is the time between the span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it. A host ms
under the profiler includes the profiler's own cost per operation, so it
compares only with other traced runs."""

from benchmark import spans

read = spans.device_ms("decode", "carta1.decode.dequantize")
