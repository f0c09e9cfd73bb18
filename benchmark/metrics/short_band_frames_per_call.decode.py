"""Band-frames in a short block mode per decode call: the count
`short_band_frames` of the program's span `carta1.decode.short_index` (the
per-band counts that the short frames' index path takes to the host anyway),
averaged over the traced calls (`benchmark/spans.py`). Layer: exact decode,
ops/qmf_kernels (K2). Moves decode_fps.

A count, not a time: neither the device's nor the profiler's clock enters
it. The span's times are read elsewhere: a device ms is the time between a
span's entry and exit events on the step's stream (its kernels, plus any
wait for the host inside it); a host ms under the profiler includes the
profiler's own cost per operation, so it compares only with other traced
runs."""

from benchmark import spans

read = spans.count("decode", "carta1.decode.short_index", "short_band_frames")
