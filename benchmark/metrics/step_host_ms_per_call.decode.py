"""Host milliseconds per decode call in the whole chunk step, on the host: the
pace at which it enqueues a call's work (and its wait for the short frames'
index), under the profiler: the program's span `carta1.decode.step`,
averaged over the traced calls (`benchmark/spans.py`). Layer: processor
chunk step (host dispatch). Moves decode_p95_ms.

A device ms is the time between the span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it. A host ms
under the profiler includes the profiler's own cost per operation, so it
compares only with other traced runs."""

from benchmark import spans

read = spans.host_ms("decode", "carta1.decode.step")
