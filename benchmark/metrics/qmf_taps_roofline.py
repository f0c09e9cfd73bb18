"""Share of its roofline that K2's QMF synthesis taps reach, percent
(`roofline.qmf_taps`). Layer: exact decode (ops/qmf_kernels). Moves
decode_fps. Sums the device time of the kernels named in KERNELS."""

from benchmark import roofline

KERNELS = ("qmf_taps_kernel",)


def read(ctx):
    tr = ctx["trace"]
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return roofline.share(roofline.qmf_taps(ctx["rows"] * ctx["frames"] * tr.calls), seconds)
