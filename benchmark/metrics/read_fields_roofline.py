"""Share of its roofline that K3's field read reaches, percent
(`roofline.read_fields`). Layer: unpack (ops/bitpack_kernels). Moves
decode_fps. Sums the device time of the kernels named in KERNELS."""

from benchmark import roofline

KERNELS = ("read_fields_kernel",)


def read(ctx):
    tr = ctx["trace"]
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return roofline.share(roofline.read_fields(ctx["rows"] * ctx["frames"] * tr.calls), seconds)
