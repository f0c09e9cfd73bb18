"""Device operations (kernels, copies, sets) per encode call, from the
profiled calls: the launches the chunk step's host dispatch makes.
Layer: the processor's chunk step.  Moves encode_fps."""

from benchmark import trace

read = trace.for_op("encode", trace.Trace.launches_per_call)
