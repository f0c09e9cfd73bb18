"""ATRAC1 format constants and tables of the codec (encode and decode).

An independent copy of every constant of `carta1_tpu/constants.py`: the
port imports nothing of the JAX package (importing any of its modules
loads JAX), so every table is rebuilt here by the same code, in float64
as the reference computes it (tests/test_torch_gold_surface.py holds
each to the JAX package's, word for word).

Parity notes (reference: aynik/carta1):
  * frame geometry / AEA layout  -> codec/core/constants.js:6-22
  * BFU layout tables            -> codec/core/constants.js:25-52
  * windows / QMF filter         -> codec/core/constants.js:60-107
  * transform + serialization    -> codec/core/constants.js:110-160
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Audio and container format
# ---------------------------------------------------------------------------
SAMPLE_RATE = 44100
SAMPLES_PER_FRAME = 512
FRAME_RATE = SAMPLE_RATE / SAMPLES_PER_FRAME

AEA_MAGIC = bytes([0x00, 0x08, 0x00, 0x00])
AEA_HEADER_SIZE = 2048
AEA_TITLE_OFFSET = 4
AEA_TITLE_SIZE = 256
AEA_FRAME_COUNT_OFFSET = 260
AEA_CHANNEL_COUNT_OFFSET = 264

SOUND_UNIT_SIZE = 212
FRAME_BITS = SOUND_UNIT_SIZE * 8           # 1696
FRAME_OVERHEAD_BITS = 40
BITRATE_PER_CHANNEL = SOUND_UNIT_SIZE * FRAME_RATE * 8

# ---------------------------------------------------------------------------
# BFU (Block Floating Unit) layout
# ---------------------------------------------------------------------------
NUM_BFUS = 52
MAX_BFU_SIZE = 20
BITS_PER_BFU_METADATA = 10

SPECS_PER_BFU = np.array(
    [8, 8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     7, 7, 7, 7, 9, 9, 9, 9, 10, 10, 10, 10, 12, 12, 12, 12, 12, 12, 12, 12,
     20, 20, 20, 20, 20, 20, 20, 20],
    dtype=np.int32,
)

BFU_AMOUNTS_COUNT = 8
BFU_AMOUNTS = np.array([20, 28, 32, 36, 40, 44, 48, 52], dtype=np.int32)
# bfu index ranges per band: band0 = [0,20), band1 = [20,36), band2 = [36,52)
BFU_BAND_BOUNDARIES = np.array([20, 36, 52], dtype=np.int32)

BFU_START_LONG = np.array(
    [0, 8, 16, 24, 32, 36, 40, 44, 48, 56, 64, 72, 80, 86, 92, 98, 104, 110,
     116, 122, 128, 134, 140, 146, 152, 159, 166, 173, 180, 189, 198, 207,
     216, 226, 236, 246, 256, 268, 280, 292, 304, 316, 328, 340, 352, 372,
     392, 412, 432, 452, 472, 492],
    dtype=np.int32,
)

BFU_START_SHORT = np.array(
    [0, 32, 64, 96, 8, 40, 72, 104, 12, 44, 76, 108, 20, 52, 84, 116, 26, 58,
     90, 122, 128, 160, 192, 224, 134, 166, 198, 230, 141, 173, 205, 237,
     150, 182, 214, 246, 256, 288, 320, 352, 384, 416, 448, 480, 268, 300,
     332, 364, 396, 428, 460, 492],
    dtype=np.int32,
)

BFU_BAND = np.searchsorted(BFU_BAND_BOUNDARIES, np.arange(NUM_BFUS), side="right").astype(np.int32)
BAND_OFFSETS = np.array([0, 128, 256, 512], dtype=np.int32)
BAND_SIZES = np.array([128, 128, 256], dtype=np.int32)

# ---------------------------------------------------------------------------
# Transforms, overlap and delays
# ---------------------------------------------------------------------------
MDCT_SIZE_SHORT = 64
MDCT_SIZE_MID = 256
MDCT_SIZE_LONG = 512

# 32-point half-sine used for every overlap window (constants.js:60-66)
WINDOW_SHORT = np.sin((np.arange(32, dtype=np.float64) + 0.5) * np.pi / 64.0)

MDCT_BAND_SIZES = (128, 128, 256)          # band samples per frame
MDCT_WINDOW_START = (48, 48, 112)          # overlap placement inside the MDCT input
MDCT_TRANSFORM_SIZES = (256, 256, 512)     # long-block MDCT input length per band
MDCT_SHORT_BLOCK_SIZE = 32
MDCT_OVERLAP_SIZE = 32
MDCT_TAIL_WINDOW_SIZE = 16
MDCT_NUM_SHORT_BLOCKS = (4, 4, 8)

QMF_TAPS = 48
QMF_DELAY = 46
QMF_HIGH_BAND_DELAY = 39

_QMF_PROTO = np.array(
    [-0.00001461907, -0.00009205479, -0.000056157569, 0.00030117269,
     0.0002422519, -0.00085293897, -0.0005205574, 0.0020340169,
     0.00078333891, -0.0042153862, -0.00075614988, 0.0078402944,
     -0.000061169922, -0.01344162, 0.0024626821, 0.021736089,
     -0.007801671, -0.034090221, 0.01880949, 0.054326009,
     -0.043596379, -0.099384367, 0.13207909, 0.46424159],
    dtype=np.float32,
)
QMF_COEFFS = _QMF_PROTO

# symmetric 48-tap window, stored f32 like the reference (constants.js:83-90)
QMF_WINDOW = np.zeros(QMF_TAPS, dtype=np.float32)
QMF_WINDOW[:24] = QMF_COEFFS * np.float32(2.0)
QMF_WINDOW[24:] = (QMF_COEFFS * np.float32(2.0))[::-1]

QMF_EVEN = QMF_WINDOW[0::2].copy()   # [24]
QMF_ODD = QMF_WINDOW[1::2].copy()    # [24]

# Whole-signal convolution form of the analysis filterbank.  With
# work = [delay(46); input], the reference computes (qmf.js:32-45)
#   low[i]  = sum_t work[2i+t] * W[47-t]
#   high[i] = sum_t work[2i+t] * W[47-t] * (+1 if t odd else -1)
# i.e. a stride-2 correlation with the kernels below.
_t = np.arange(QMF_TAPS)
QMF_KERNEL_LOW = QMF_WINDOW[47 - _t].astype(np.float32)            # [48]
QMF_KERNEL_HIGH = (QMF_KERNEL_LOW * np.where(_t % 2 == 1, 1.0, -1.0)).astype(np.float32)

# transient detection FFT sizes per band (constants.js:110-113)
FFT_SIZE_LOW = 128
FFT_SIZE_MID = 128
FFT_SIZE_HIGH = 256
TRANSIENT_FFT_SIZES = (FFT_SIZE_LOW, FFT_SIZE_MID, FFT_SIZE_HIGH)

# ---------------------------------------------------------------------------
# Serialization, quantization and PCM
# ---------------------------------------------------------------------------
FRAME_HEADER_BITS = 16
FRAME_WORD_LENGTH_BITS = 4
FRAME_SCALE_FACTOR_BITS = 6
QUANTIZATION_SIGN_BIT_SHIFT = 1
WORD_LENGTH_BITS = np.array(
    [0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16], dtype=np.int32
)
MAX_WORD_LENGTH_INDEX = 15

# scale factor table 2^(i/3 - 21) (f64, constants.js:144-150)
SCALE_FACTORS = np.power(2.0, np.arange(64, dtype=np.float64) / 3.0 - 21.0)

# 2^-b distortion table (f64, constants.js:153-160)
INV_POWER_OF_TWO = np.power(2.0, -np.arange(int(WORD_LENGTH_BITS[15]) + 1, dtype=np.float64))

CODEC_DELAY = 266  # total algorithmic latency in samples (tests/decoder.test.js:22)

WAV_HEADER_SIZE = 44
WAV_DATA_OFFSET = 36
WAV_BITS_PER_SAMPLE = 16
WAV_BYTES_PER_SAMPLE = 2
WAV_PCM_MAX_POSITIVE = 0x7FFF
WAV_PCM_MAX_NEGATIVE = 0x8000

# The 212-byte sound unit of a silent frame (n_bfu = 0, all bands long):
# only the 16-bit header is non-zero.  Odd stereo streams are padded with
# it (processor.js:201-211).
SILENT_UNIT = np.zeros(SOUND_UNIT_SIZE, dtype=np.uint8)
SILENT_UNIT[0], SILENT_UNIT[1] = 0xAC, 0x00   # (2<<14)|(2<<12)|(3<<10)|(0<<5)


def bfu_gather_indices() -> tuple[np.ndarray, np.ndarray]:
    """BFU <-> coefficient index maps.

    gather_idx : int32 [2, NUM_BFUS, MAX_BFU_SIZE]
        gather_idx[mode, bfu, k] is the coefficient position feeding slot k
        of `bfu` under block mode `mode` (0 = long, 1 = short), or -1 where
        the slot is padding (quantization.js:126-138).
    scatter_idx : int32 [2, 512]
        scatter_idx[mode, pos] is the flat (bfu, k) slot that writes
        coefficient `pos`, or -1.
    """
    gather = np.full((2, NUM_BFUS, MAX_BFU_SIZE), -1, dtype=np.int32)
    scatter = np.full((2, 512), -1, dtype=np.int32)
    for mode, starts in enumerate((BFU_START_LONG, BFU_START_SHORT)):
        for bfu in range(NUM_BFUS):
            band = int(BFU_BAND[bfu])
            b0, b1 = int(BAND_OFFSETS[band]), int(BAND_OFFSETS[band + 1])
            for k in range(int(SPECS_PER_BFU[bfu])):
                pos = int(starts[bfu]) + k
                if b0 <= pos < b1:
                    gather[mode, bfu, k] = pos
                    scatter[mode, pos] = bfu * MAX_BFU_SIZE + k
    return gather, scatter


BFU_GATHER_IDX, BFU_SCATTER_IDX = bfu_gather_indices()

# per-BFU slot mask [NUM_BFUS, MAX_BFU_SIZE]: slot k valid iff k < size
BFU_SLOT_MASK = np.arange(MAX_BFU_SIZE)[None, :] < SPECS_PER_BFU[:, None]
