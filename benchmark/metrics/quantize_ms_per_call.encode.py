"""Device milliseconds per encode call in the quantizer and the `FrameData` (in
the exact engine also the state's copy): the program's span
`carta1.encode.quantize`, averaged over the traced calls
(`benchmark/spans.py`). Layer: quantize, pack. Moves encode_fps.

A device ms is the time between the span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it. A host ms
under the profiler includes the profiler's own cost per operation, so it
compares only with other traced runs."""

from benchmark import spans

read = spans.device_ms("encode", "carta1.encode.quantize")
