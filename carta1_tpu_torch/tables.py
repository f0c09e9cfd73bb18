"""Host float64 tables of the exact transforms.

Copies of the gold engine's table builders (`carta1_tpu/gold/transforms.py`
`_sincos_table`, `carta1_tpu/gold/fftjs.py` `_bit_reverse_perm` and
`_twiddles`), built by the same code so that each value is the same f64
word, plus the packed per-size layout the IMDCT kernel reads.
"""

from __future__ import annotations

import functools

import numpy as np

# Reference inverse transform instances (mdct.js:215-221)
IMDCT_SCALES = {64: 512.0, 256: 2048.0, 512: 2048.0}


@functools.lru_cache(maxsize=None)
def _sincos_table(size: int, scale: float) -> np.ndarray:
    """f64 twiddle table of MDCTBase (mdct.js:20-38): [size/2] interleaved
    (cos, sin) pairs scaled by sqrt(scale/size)."""
    quarter = size >> 2
    alpha = 2.0 * np.pi / (8.0 * size)
    omega = 2.0 * np.pi / size
    root = np.sqrt(scale / size)
    table = np.zeros(size >> 1, dtype=np.float64)
    i = np.arange(quarter, dtype=np.float64)
    angle = omega * i + alpha
    table[0::2] = root * np.cos(angle)
    table[1::2] = root * np.sin(angle)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = int(np.log2(n))
    perm = np.zeros(n, dtype=np.int64)
    for i in range(n):
        r = 0
        t = i
        for _ in range(bits):
            r = (r << 1) | (t & 1)
            t >>= 1
        perm[i] = r
    perm.setflags(write=False)
    return perm


@functools.lru_cache(maxsize=None)
def _twiddles(stride: int) -> tuple[np.ndarray, np.ndarray]:
    """f64 twiddle factors for one FFT stage, via the reference's recurrence.

    Must NOT be replaced with cos/sin(k*angle): the reference generates
    twiddle k by k complex multiplications in f64 (fft.js:42-65), and the
    accumulated rounding differs from the closed form in the last ulps.
    """
    half = stride >> 1
    angle = -2.0 * np.pi / stride
    w_re, w_im = np.cos(angle), np.sin(angle)
    tr = np.empty(half, dtype=np.float64)
    ti = np.empty(half, dtype=np.float64)
    cr, ci = 1.0, 0.0
    for k in range(half):
        tr[k], ti[k] = cr, ci
        cr, ci = cr * w_re - ci * w_im, cr * w_im + ci * w_re
    tr.setflags(write=False)
    ti.setflags(write=False)
    return tr, ti


@functools.lru_cache(maxsize=None)
def imdct_tables(size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Everything one IMDCT size needs, flat, for the kernel and its plain twin.

    Returns (sincos f64 [size/2], perm int32 [size/4], tw_re f64 [size/4 - 1],
    tw_im f64 [size/4 - 1]); tw_* concatenate the FFT stages' twiddles,
    stride 2 first, each stage holding stride/2 entries."""
    n = size >> 2
    tw = [_twiddles(1 << s) for s in range(1, n.bit_length())]
    tw_re = np.concatenate([t[0] for t in tw])
    tw_im = np.concatenate([t[1] for t in tw])
    assert tw_re.shape == (n - 1,)
    perm = _bit_reverse_perm(n).astype(np.int32)
    return _sincos_table(size, IMDCT_SCALES[size]), perm, tw_re, tw_im
