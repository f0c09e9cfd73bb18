"""Device milliseconds per decode call in `unpack_frames` (the int64 layout
glue and K3): the program's span `carta1.decode.unpack`, averaged over the
traced calls (`benchmark/spans.py`). Layer: unpack, ops/bitpack_kernels
(K3). Moves decode_fps.

A device ms is the time between the span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it. A host ms
under the profiler includes the profiler's own cost per operation, so it
compares only with other traced runs."""

from benchmark import spans

read = spans.device_ms("decode", "carta1.decode.unpack")
