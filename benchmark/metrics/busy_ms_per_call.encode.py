"""Device busy milliseconds per encode call: the union of the device
intervals of the profiled calls over their count.  Layer: device.
Moves encode_fps."""

from benchmark import trace

read = trace.for_op("encode", trace.Trace.busy_ms_per_call)
