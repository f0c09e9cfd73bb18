"""Device busy milliseconds per decode call: the union of the device
intervals of the profiled calls over their count.  Layer: device.
Moves decode_fps."""

from benchmark import trace

read = trace.for_op("decode", trace.Trace.busy_ms_per_call)
