"""Peaks of the card and the work of each hand kernel's stage.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity,
at its full power limit of 700 W: 34 TFLOP/s float64 and 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s of HBM3.  A roofline share is
the least time these allow for the stage's work, the larger of
operations / peak and bytes / bandwidth, over the measured device time.

The work is what the algorithm needs at the cell's shapes, not what the
present kernel does: each input byte read once, each output byte written
once, every arithmetic operation of the algorithm counted once, so that a
later kernel doing the same work reads against the same count.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
F = 4                                          # bytes of a float32 or int32

# the codec's geometry
COEFFS = 512                                   # spectral coefficients of a frame
BFUS = 52
SLOTS = BFUS * 20                              # BFU slots of the unpacked layout
UNIT = 212                                     # bytes of a sound unit
WORD_LENGTHS = 16


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


def share(work: tuple[float, float, str], device_seconds: float) -> float | None:
    """Percent of the roofline: least time / measured time; None when the
    kernel did not run."""
    if device_seconds <= 0:
        return None
    return 100.0 * least_seconds(*work) / device_seconds


def alloc_rdo(frames: int) -> tuple[float, float, str]:
    """The measured-distortion allocator: at each of 16 word lengths every
    coefficient is quantized (scale, round half away: add, truncate,
    clamp), dequantized and its error squared and summed (9 float32
    operations); per BFU the 15 step prices (difference, scale), their
    running maximum and the sweep's compare and subtract (60).  Reads the
    512 coefficients and 52 scale factors, writes 52 word lengths."""
    flops = frames * (COEFFS * WORD_LENGTHS * 9 + BFUS * 60)
    nbytes = frames * (COEFFS * F + BFUS * F + BFUS * F)
    return flops, nbytes, "f32"


def read_fields(frames: int) -> tuple[float, float, str]:
    """The unpack's field read: each 212-byte unit read, its 52 scale
    factors and 1,040 coefficient slots written as int32.  No arithmetic
    worth counting: the bound is bytes."""
    return 0.0, frames * (UNIT + (BFUS + SLOTS) * F), "f64"


def qmf_taps(frames: int) -> tuple[float, float, str]:
    """The decoder's two QMF syntheses: 256 then 512 outputs a frame, each
    24 float64 products and 24 additions; the merged input and the output
    of each read and written once as float32."""
    outputs = 256 + 512
    return frames * outputs * 48, frames * outputs * 2 * F, "f64"


def _fft(n: int) -> float:
    """Radix-2 complex FFT of n points: n/2 log2 n butterflies of 10
    operations (a complex product and two complex additions)."""
    return n / 2 * math.log2(n) * 10


def mdct(size: int) -> tuple[float, float]:
    """(operations, bytes) of one forward MDCT of `size` inputs (mdct.js):
    8 operations per FFT point before the FFT of size/4 points, 6 after;
    reads size floats, writes size/2."""
    n = size // 4
    return 8 * n + _fft(n) + 6 * n, (size + size // 2) * F


def spectrum(size: int) -> tuple[float, float]:
    """(operations, bytes) of one magnitude spectrum: the FFT of `size`
    points, then 4 operations per positive bin; reads size floats, writes
    size/2."""
    return _fft(size) + 4 * (size // 2), (size + size // 2) * F


def fftjs(frames: int, short_blocks: int) -> tuple[float, float, str]:
    """The exact encoder's transforms (K6): per frame the long MDCTs of the
    three bands (256, 256, 512) and their magnitude spectra (128, 128,
    256); the 64-point MDCT of each short block whose band is in a short
    mode, `short_blocks` of them in all (only those need it)."""
    per_frame = [mdct(256), mdct(256), mdct(512), spectrum(128), spectrum(128), spectrum(256)]
    short = mdct(64)
    flops = frames * sum(w[0] for w in per_frame) + short_blocks * short[0]
    nbytes = frames * sum(w[1] for w in per_frame) + short_blocks * short[1]
    return flops, nbytes, "f64"
