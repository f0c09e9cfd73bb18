"""Idle share of the card over the profiled decode calls, percent: 1 - device
busy (the union of every kernel, copy and set interval) / the host wall
of those whole calls.  Layer: device.  Moves decode_fps."""

from benchmark import trace

read = trace.for_op("decode", trace.Trace.idle_pct)
