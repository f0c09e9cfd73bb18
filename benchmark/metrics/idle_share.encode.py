"""Idle share of the card over the profiled encode calls, percent: 1 - device
busy (the union of every kernel, copy and set interval) / the host wall
of those whole calls.  Layer: device.  Moves encode_fps."""

from benchmark import trace

read = trace.for_op("encode", trace.Trace.idle_pct)
