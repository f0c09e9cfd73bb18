"""Share of its roofline that K4's measured-distortion allocator reaches,
percent (`roofline.alloc_rdo`). Layer: allocation
(ops/bitalloc_kernels). Moves encode_fps. Sums the device time of the
kernels named in KERNELS."""

from benchmark import roofline

KERNELS = ("alloc_rdo_kernel",)


def read(ctx):
    tr = ctx["trace"]
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return roofline.share(roofline.alloc_rdo(ctx["rows"] * ctx["frames"] * tr.calls), seconds)
