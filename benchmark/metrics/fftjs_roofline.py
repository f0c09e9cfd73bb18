"""Share of its roofline that K6's transforms reach in the exact encoder,
percent (`roofline.fftjs`: the long MDCTs and magnitude spectra of every
frame, the 64-point MDCT of the short blocks only, counted from the
block modes in the profiled calls' units). Layer: exact engine, gold/ on
ops/fftjs_kernels. Moves encode_fps. Sums the device time of the kernels
named in KERNELS."""

from benchmark import roofline
from benchmark.reference import bitstream

KERNELS = ("fftjs_kernel", "mdct64_kernel")
SHORT_BLOCKS = (4, 4, 8)                   # short blocks of a band in a short mode


def short_blocks(units) -> int:
    """Short blocks of the frames of uint8 units [..., 212]."""
    short = bitstream.modes(units) != 0
    return int(sum(int(short[..., b].sum()) * n for b, n in enumerate(SHORT_BLOCKS)))


def read(ctx):
    tr = ctx["trace"]
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0 or ctx["op"] != "encode":
        return None
    shorts = sum(short_blocks(u) for u in tr.outputs)
    return roofline.share(roofline.fftjs(ctx["rows"] * ctx["frames"] * tr.calls, shorts), seconds)
