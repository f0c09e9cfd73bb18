"""The ATRAC1 format's numbers, written out for the reference alone.

The values follow the format as the reference JavaScript encoder
(aynik/carta1, codec/core/constants.js) defines them: frame geometry, the
BFU layout, the half-sine window, the 48-tap QMF prototype, the scale
factor and word length tables.  Float tables are made in float64, as
JavaScript makes them, and stored in the precision the reference stores
them in.  Nothing here is read from the package under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLES_PER_FRAME = 512
SOUND_UNIT_SIZE = 212
FRAME_BITS = SOUND_UNIT_SIZE * 8                     # 1696
FRAME_OVERHEAD_BITS = 40
NUM_BFUS = 52
MAX_BFU_SIZE = 20
BITS_PER_BFU_METADATA = 10
BUDGET_BITS = FRAME_BITS - FRAME_OVERHEAD_BITS - NUM_BFUS * BITS_PER_BFU_METADATA   # 1136

SPECS_PER_BFU = np.array(
    [8, 8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     7, 7, 7, 7, 9, 9, 9, 9, 10, 10, 10, 10, 12, 12, 12, 12, 12, 12, 12, 12,
     20, 20, 20, 20, 20, 20, 20, 20], dtype=np.int64)
BFU_AMOUNTS = np.array([20, 28, 32, 36, 40, 44, 48, 52], dtype=np.int64)
BFU_BAND = np.array([0] * 20 + [1] * 16 + [2] * 16, dtype=np.int64)
BAND_OFFSETS = (0, 128, 256, 512)
BFU_START_LONG = np.array(
    [0, 8, 16, 24, 32, 36, 40, 44, 48, 56, 64, 72, 80, 86, 92, 98, 104, 110,
     116, 122, 128, 134, 140, 146, 152, 159, 166, 173, 180, 189, 198, 207,
     216, 226, 236, 246, 256, 268, 280, 292, 304, 316, 328, 340, 352, 372,
     392, 412, 432, 452, 472, 492], dtype=np.int64)
BFU_START_SHORT = np.array(
    [0, 32, 64, 96, 8, 40, 72, 104, 12, 44, 76, 108, 20, 52, 84, 116, 26, 58,
     90, 122, 128, 160, 192, 224, 134, 166, 198, 230, 141, 173, 205, 237,
     150, 182, 214, 246, 256, 288, 320, 352, 384, 416, 448, 480, 268, 300,
     332, 364, 396, 428, 460, 492], dtype=np.int64)

BAND_SIZES = (128, 128, 256)
TRANSFORM_SIZES = (256, 256, 512)            # long-block MDCT input per band
WINDOW_START = (48, 48, 112)                 # where the overlap sits in that input
SHORT_BLOCKS = (4, 4, 8)
TAIL = 16                                    # decoder overlap tail per band
TRANSIENT_FFT_SIZES = (128, 128, 256)
QMF_DELAY = 46
QMF_HIGH_BAND_DELAY = 39
MDCT_SCALES = {64: 0.5, 256: 0.5, 512: 1.0}
IMDCT_SCALES = {64: 512.0, 256: 2048.0, 512: 2048.0}

WINDOW_SHORT = np.sin((np.arange(32, dtype=np.float64) + 0.5) * np.pi / 64.0)

_QMF_PROTO = np.array(
    [-0.00001461907, -0.00009205479, -0.000056157569, 0.00030117269,
     0.0002422519, -0.00085293897, -0.0005205574, 0.0020340169,
     0.00078333891, -0.0042153862, -0.00075614988, 0.0078402944,
     -0.000061169922, -0.01344162, 0.0024626821, 0.021736089,
     -0.007801671, -0.034090221, 0.01880949, 0.054326009,
     -0.043596379, -0.099384367, 0.13207909, 0.46424159], dtype=np.float32)
QMF_WINDOW = np.concatenate([_QMF_PROTO * np.float32(2.0), (_QMF_PROTO * np.float32(2.0))[::-1]])
QMF_EVEN = QMF_WINDOW[0::2].astype(np.float64)      # [24], f32 values
QMF_ODD = QMF_WINDOW[1::2].astype(np.float64)

WORD_LENGTH_BITS = np.array([0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16], dtype=np.int64)
SCALE_FACTORS = np.power(2.0, np.arange(64, dtype=np.float64) / 3.0 - 21.0)
INV_POWER_OF_TWO = np.power(2.0, -np.arange(17, dtype=np.float64))
QUANT_RANGES = np.array([0] + [(1 << (b - 1)) - 1 for b in WORD_LENGTH_BITS[1:]], dtype=np.int64)


def _bfu_maps() -> tuple[np.ndarray, np.ndarray]:
    """gather [2, 52, 20]: the spectrum position feeding slot k of a BFU in
    a long (0) or short (1) band, -1 for padding; scatter [2, 512]: the
    flat slot each position is read from."""
    gather = np.full((2, NUM_BFUS, MAX_BFU_SIZE), -1, np.int64)
    scatter = np.full((2, 512), -1, np.int64)
    for mode, starts in enumerate((BFU_START_LONG, BFU_START_SHORT)):
        for b in range(NUM_BFUS):
            band = BFU_BAND[b]
            lo, hi = BAND_OFFSETS[band], BAND_OFFSETS[band + 1]
            for k in range(SPECS_PER_BFU[b]):
                pos = starts[b] + k
                if lo <= pos < hi:
                    gather[mode, b, k] = pos
                    scatter[mode, pos] = b * MAX_BFU_SIZE + k
    return gather, scatter


BFU_GATHER, BFU_SCATTER = _bfu_maps()
SLOT_MASK = np.arange(MAX_BFU_SIZE)[None, :] < SPECS_PER_BFU[:, None]     # [52, 20]


def sincos_table(size: int, scale: float) -> np.ndarray:
    """f64 [size/2] interleaved (cos, sin) of the MDCT's twiddles, scaled
    by sqrt(scale / size) (mdct.js:20-38)."""
    quarter = size >> 2
    alpha = 2.0 * np.pi / (8.0 * size)
    omega = 2.0 * np.pi / size
    root = np.sqrt(scale / size)
    table = np.zeros(size >> 1, dtype=np.float64)
    angle = omega * np.arange(quarter, dtype=np.float64) + alpha
    table[0::2] = root * np.cos(angle)
    table[1::2] = root * np.sin(angle)
    return table


def stage_twiddles(stride: int) -> tuple[np.ndarray, np.ndarray]:
    """f64 twiddles of one radix-2 stage by the reference's recurrence
    (fft.js:42-65): twiddle k is k complex products, never cos(k angle)."""
    half = stride >> 1
    angle = -2.0 * np.pi / stride
    w_re, w_im = np.cos(angle), np.sin(angle)
    tr, ti = np.empty(half), np.empty(half)
    cr, ci = 1.0, 0.0
    for k in range(half):
        tr[k], ti[k] = cr, ci
        cr, ci = cr * w_re - ci * w_im, cr * w_im + ci * w_re
    return tr, ti


def bit_reverse(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)], np.int64)


@functools.lru_cache(maxsize=None)
def on(name: str, device: torch.device, *args) -> torch.Tensor:
    """A table above (or made by one of the functions above from `args`)
    as a tensor on `device`, made once per device."""
    value = globals()[name]
    if callable(value):
        value = value(*args)
    if isinstance(value, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in value)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)
