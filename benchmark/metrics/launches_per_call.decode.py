"""Device operations (kernels, copies, sets) per decode call, from the
profiled calls: the launches the chunk step's host dispatch makes.
Layer: the processor's chunk step.  Moves decode_fps."""

from benchmark import trace

read = trace.for_op("decode", trace.Trace.launches_per_call)
