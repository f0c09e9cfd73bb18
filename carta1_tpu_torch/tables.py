"""Host float64 tables of the transforms and the quantizer.

Copies of the gold engine's table builders (`carta1_tpu/gold/transforms.py`
`_sincos_table`, `mdct_js`, `imdct_js`, `mdct_basis`, `imdct_basis`; `carta1_tpu/gold/fftjs.py`
`_bit_reverse_perm`, `_twiddles`, `fft_js`) and of the encoder tables of
`carta1_tpu/ops/tables.py`, built by the same code so that each value is
the same word, plus the packed per-size layout the IMDCT kernel reads.
"""

from __future__ import annotations

import functools

import numpy as np

from carta1_tpu_torch import constants as C

# Reference transform instances (mdct.js:215-221)
MDCT_SCALES = {64: 0.5, 256: 0.5, 512: 1.0}
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
def fft_tables(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """What an n-point fft.js FFT needs, flat, for the kernels and their
    plain versions: (perm int32 [n], tw_re f64 [n - 1], tw_im f64 [n - 1]);
    tw_* concatenate the stages' twiddles, stride 2 first, each stage
    holding stride/2 entries, so stage q's twiddle k is entry 2^q - 1 + k."""
    tw = [_twiddles(1 << s) for s in range(1, n.bit_length())]
    tw_re = np.concatenate([t[0] for t in tw])
    tw_im = np.concatenate([t[1] for t in tw])
    assert tw_re.shape == (n - 1,)
    return _bit_reverse_perm(n).astype(np.int32), tw_re, tw_im


@functools.lru_cache(maxsize=None)
def imdct_tables(size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Everything one IMDCT size needs, flat, for the kernel and its plain twin:
    (sincos f64 [size/2], perm int32 [size/4], tw_re, tw_im f64 [size/4 - 1])."""
    return (_sincos_table(size, IMDCT_SCALES[size]), *fft_tables(size >> 2))


@functools.lru_cache(maxsize=None)
def mdct_tables(size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The same for the forward MDCT (mdct.js:54-122) with the reference's
    scale: (sincos f64 [size/2], perm, tw_re, tw_im)."""
    return (_sincos_table(size, MDCT_SCALES[size]), *fft_tables(size >> 2))


# ---------------------------------------------------------------------------
# Forward MDCT operators (encoder)
# ---------------------------------------------------------------------------
def _fft_f64(re: np.ndarray, im: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The reference's radix-2 DIT FFT (fft.js:14-68) over the last axis, on
    f64 arrays: no store rounds, so this is the exact linear transform."""
    n = re.shape[-1]
    perm = _bit_reverse_perm(n)
    re, im = np.ascontiguousarray(re[..., perm]), np.ascontiguousarray(im[..., perm])
    stride = 2
    while stride <= n:
        half = stride >> 1
        tr, ti = _twiddles(stride)
        shape = re.shape[:-1] + (n // stride, stride)
        rev, imv = re.reshape(shape), im.reshape(shape)
        er, ei = rev[..., :half], imv[..., :half]
        orr, oi = rev[..., half:], imv[..., half:]
        t_r = orr * tr - oi * ti
        t_i = orr * ti + oi * tr
        re = np.concatenate([er + t_r, er - t_r], axis=-1).reshape(re.shape)
        im = np.concatenate([ei + t_i, ei - t_i], axis=-1).reshape(im.shape)
        stride <<= 1
    return re, im


def _mdct_f64(x: np.ndarray, size: int, scale: float) -> np.ndarray:
    """Forward MDCT (mdct.js:54-122) on f64 input: [..., size] -> [..., size/2]."""
    half, quarter = size >> 1, size >> 2
    fft_size = half >> 1
    n34 = 3 * quarter
    tbl = _sincos_table(size, scale)
    re = np.zeros(x.shape[:-1] + (fft_size,), dtype=np.float64)
    im = np.zeros_like(re)

    i = np.arange(0, quarter, 2)
    r = x[..., n34 - 1 - i] + x[..., n34 + i]
    s_ = x[..., quarter + i] - x[..., quarter - 1 - i]
    c, s = tbl[i], tbl[i + 1]
    re[..., i >> 1] = r * c + s_ * s
    im[..., i >> 1] = s_ * c - r * s

    i = np.arange(quarter, half, 2)
    r = x[..., n34 - 1 - i] - x[..., i - quarter]
    s_ = x[..., quarter + i] + x[..., 5 * quarter - 1 - i]
    c, s = tbl[i], tbl[i + 1]
    re[..., i >> 1] = r * c + s_ * s
    im[..., i >> 1] = s_ * c - r * s

    re, im = _fft_f64(re, im)

    out = np.zeros(x.shape[:-1] + (half,), dtype=np.float64)
    i = np.arange(fft_size)
    c, s = tbl[i * 2], tbl[i * 2 + 1]
    out[..., i * 2] = -re * c - im * s
    out[..., half - 1 - i * 2] = -re * s + im * c
    return out


@functools.lru_cache(maxsize=None)
def mdct_basis(size: int) -> np.ndarray:
    """Exact f64 forward-MDCT matrix [size, size/2]: out = x @ mdct_basis(size).

    The identity fed through the f64 path of the reference algorithm (the
    transform is linear, so this is the exact operator)."""
    return _mdct_f64(np.eye(size, dtype=np.float64), size, MDCT_SCALES[size])


def _imdct_f64(x: np.ndarray, size: int, scale: float) -> np.ndarray:
    """Inverse MDCT (mdct.js:139-211) on f64 input: [..., size/2] -> [..., size]."""
    half, quarter = size >> 1, size >> 2
    fft_size = half >> 1
    n34 = 3 * quarter
    tbl = _sincos_table(size, scale)

    i = np.arange(fft_size)
    i2 = i * 2
    r = -x[..., i2]
    s_ = -x[..., half - 1 - i2]
    c, s = tbl[i2], tbl[i2 + 1]
    re, im = _fft_f64(s_ * s + r * c, s_ * c - r * s)

    out = np.zeros(x.shape[:-1] + (size,), dtype=np.float64)
    i = np.arange(fft_size // 2)
    i2 = i * 2
    c, s = tbl[i2], tbl[i2 + 1]
    r1 = re[..., i] * c + im[..., i] * s
    i1 = re[..., i] * s - im[..., i] * c
    out[..., n34 - 1 - i2] = r1
    out[..., n34 + i2] = r1
    out[..., quarter + i2] = i1
    out[..., quarter - 1 - i2] = -i1

    i = np.arange(fft_size // 2, fft_size)
    idx = (i - fft_size // 2) * 2 + quarter
    i2 = i * 2
    c, s = tbl[i2], tbl[i2 + 1]
    r1 = re[..., i] * c + im[..., i] * s
    i1 = re[..., i] * s - im[..., i] * c
    out[..., n34 - 1 - idx] = r1
    out[..., idx - quarter] = -r1
    out[..., quarter + idx] = i1
    out[..., 5 * quarter - 1 - idx] = i1
    return out


@functools.lru_cache(maxsize=None)
def imdct_basis(size: int) -> np.ndarray:
    """Exact f64 inverse-MDCT matrix [size/2, size]: out = x @ imdct_basis(size)."""
    return _imdct_f64(np.eye(size >> 1, dtype=np.float64), size, IMDCT_SCALES[size])


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).astype(np.float32)


@functools.lru_cache(maxsize=None)
def encoder_mdct_tables() -> dict[str, np.ndarray]:
    """Window-folded forward-MDCT matrices, f32.

    Long blocks (encoder.js:221-251): the MDCT input of size `tsize` is
    [zeros(ws), W_up*tail_prev, band (last 32 down-windowed), zeros], so
      coeffs = tail_prev @ OV + band @ MAIN
    with OV   = diag(W_up)  @ B[ws:ws+32]           [32, size]
         MAIN = diag(w_vec) @ B[ws+32:ws+32+size]   [size, size]
    where w_vec is 1 except W_down on the last 32 samples and B is the f64
    basis of mdct256/mdct512.  Mid and high band spectra are reversed (a
    column flip, folded in).

    Short blocks (encoder.js:262-300): per 32-sample block,
      coeffs_b = ov_raw_b @ SOV + block_b @ SMAIN   (each [32, 32])
    with the per-block spectral reversal folded in for mid and high."""
    w_up, w_down = C.WINDOW_SHORT, C.WINDOW_SHORT[::-1]
    out = {}
    for band in range(3):
        size = C.MDCT_BAND_SIZES[band]
        ws = C.MDCT_WINDOW_START[band]
        basis = mdct_basis(C.MDCT_TRANSFORM_SIZES[band])
        ov = w_up[:, None] * basis[ws:ws + 32]
        w_vec = np.ones(size)
        w_vec[-32:] = w_down
        main = w_vec[:, None] * basis[ws + 32: ws + 32 + size]
        if band > 0:
            ov, main = ov[:, ::-1], main[:, ::-1]
        out[f"long_ov{band}"] = _f32(ov)
        out[f"long_main{band}"] = _f32(main)
    b64 = mdct_basis(64)
    sov = w_up[:, None] * b64[:32]
    smain = w_down[:, None] * b64[32:]
    out["short_ov"], out["short_main"] = _f32(sov), _f32(smain)
    out["short_ov_rev"], out["short_main_rev"] = _f32(sov[:, ::-1]), _f32(smain[:, ::-1])
    return out


@functools.lru_cache(maxsize=None)
def decoder_imdct_tables() -> dict[str, np.ndarray]:
    """IMDCT matrices of the fast decoder, f32, giving directly the middle
    half the decoder keeps (decoder.js:190-199: inv[size/2 : size/2 + size]
    of a 2*size transform), with the mid/high spectral reversal folded in
    as a row flip: long{b} [size, size], short / short_rev [32, 32]."""
    out = {}
    for band in range(3):
        size = C.MDCT_BAND_SIZES[band]
        mid = imdct_basis(2 * size)[:, size // 2: size // 2 + size]
        out[f"long{band}"] = _f32(mid[::-1] if band > 0 else mid)
    b64 = imdct_basis(64)
    out["short"] = _f32(b64[:, 16:48])
    out["short_rev"] = _f32(b64[::-1, 16:48])
    return out


# ---------------------------------------------------------------------------
# Quantizer and allocator tables
# ---------------------------------------------------------------------------
_bits = C.WORD_LENGTH_BITS.astype(np.int64)
QUANT_RANGES = np.where(_bits > 0, (1 << np.maximum(_bits - 1, 0)) - 1, 0)   # [16] int

# candidate steps wl -> wl + 1 for wl in 0..14 (bitallocation.js:91-105)
_wl = np.arange(15)
_b1 = C.WORD_LENGTH_BITS[_wl].astype(np.float64)
_b2 = C.WORD_LENGTH_BITS[_wl + 1].astype(np.float64)
_f1 = np.where(_b1 == 0, 2.0, 2.0 ** -_b1)
_f2 = 2.0 ** -_b2
RDO_STEP_GAIN = ((_f1 - _f2) / (_b2 - _b1)).astype(np.float32)   # [15]
RDO_STEP_BITS = (_b2 - _b1).astype(np.int32)                     # [15]

# per-candidate (bfu, wl) tables, flattened [52 * 15]
RDO_CAND_BFU = np.repeat(np.arange(C.NUM_BFUS, dtype=np.int32), 15)
RDO_CAND_WL = np.tile(np.arange(15, dtype=np.int32), C.NUM_BFUS)
RDO_CAND_COST = (RDO_STEP_BITS[RDO_CAND_WL] * C.SPECS_PER_BFU[RDO_CAND_BFU]).astype(np.int32)
RDO_BUDGET = int(C.FRAME_BITS - C.FRAME_OVERHEAD_BITS - C.NUM_BFUS * C.BITS_PER_BFU_METADATA)   # 1136


@functools.lru_cache(maxsize=None)
def heap_priority_table(bias: float) -> np.ndarray:
    """f64 [64, 15]: the reference heap's priority of the step wl -> wl + 1
    of a BFU whose scale factor index is sf (bitallocation.js:91-105,
    `carta1_tpu/gold/coding.py` allocate_bits_frame `priority`), computed
    on the host by the same NumPy scalar operations in the same order:
    eff = SCALE_FACTORS[sf] ** bias, then eff * (f1 - f2) / (b2 - b1).  No
    device `pow` or division decides a priority."""
    wlb = C.WORD_LENGTH_BITS
    out = np.zeros((64, C.MAX_WORD_LENGTH_INDEX), np.float64)
    for sf in range(64):
        eff = C.SCALE_FACTORS[sf] ** bias
        for cur in range(C.MAX_WORD_LENGTH_INDEX):
            b1, b2 = int(wlb[cur]), int(wlb[cur + 1])
            f1 = 2.0 if b1 == 0 else C.INV_POWER_OF_TWO[b1]
            out[sf, cur] = eff * (f1 - C.INV_POWER_OF_TWO[b2]) / (b2 - b1)
    out.setflags(write=False)
    return out
