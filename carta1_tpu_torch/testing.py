"""Seeded edge inputs for the tiled kernels K1 (IMDCT) and K2 (QMF taps).

One NumPy generator, used by the CPU tests (plain versions against the
gold engine), by the card tests and by `chip_smoke.py` (kernels against
their plain versions).  The batches sit on and around a block's tile of
rows; the values are the ones a tiling or a rounding can get wrong: +0,
-0, f32 denormals, magnitudes whose f64 result rounds to inf at the final
f32 store, and a single nonzero sample at either end of a row.  No row
overflows before its last rounding, so no NaN appears and bitwise
comparison stays meaningful.
"""

from __future__ import annotations

import numpy as np

PATTERNS = 8
F32_MAX = float(np.finfo(np.float32).max)


def edge_cases(tile: int) -> list[tuple[int, int]]:
    """(rows, seed) pairs around one block's tile of rows: 1, 2, tile - 1,
    tile + 1 and a prime above several tiles.  A batch smaller than
    PATTERNS comes once per seed, so that it sees every row pattern; a
    larger one holds them all."""
    batches = sorted({1, 2, max(tile - 1, 1), tile + 1, 131})
    return [(b, seed) for b in batches for seed in (range(PATTERNS) if b < PATTERNS else (b,))]


def _denormals(rng: np.random.Generator, n: int) -> np.ndarray:
    bits = rng.integers(1, 1 << 23, n).astype(np.uint32) | (rng.integers(0, 2, n).astype(np.uint32) << 31)
    return bits.view(np.float32)


def edge_rows(batch: int, cols: int, seed: int, big: float) -> np.ndarray:
    """f32 [batch, cols]; row r follows pattern (r + seed) % PATTERNS.

    `big` is the magnitude of the lone samples meant to overflow at the
    consumer's final f32 rounding (and of nothing else)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, cols), np.float32)
    for r in range(batch):
        p = (r + seed) % PATTERNS
        if p == 0:                                            # ordinary spectra over 14 binades
            out[r] = rng.standard_normal(cols) * np.exp2(rng.integers(-10, 4, cols))
        elif p == 1:
            out[r] = 0.0
        elif p == 2:
            out[r] = -0.0
        elif p == 3:
            out[r] = _denormals(rng, cols)
        elif p == 4:                                          # one sample at the row's start
            out[r, 0] = big if r % 2 else -big
        elif p == 5:                                          # one sample at the row's end
            out[r, -1] = -big if r % 2 else big
        elif p == 6:                                          # unit impulses at both ends
            out[r, 0], out[r, -1] = 1.0, -1.0
        else:                                                 # a mix: zeros of both signs, denormals, large values
            row = (rng.standard_normal(cols) * 1e30).astype(np.float32)
            kind = rng.integers(0, 4, cols)
            row[kind == 1] = 0.0
            row[kind == 2] = -0.0
            row[kind == 3] = _denormals(rng, int((kind == 3).sum()))
            out[r] = row
    return out


def imdct_edge_spectra(size: int, batch: int, seed: int) -> np.ndarray:
    """f32 [batch, size/2] spectra for `imdct_mid`.  A lone coefficient of
    0.3 * F32_MAX stays finite through the pre-twiddle and the FFT stages
    (each scales it by at most sqrt(8)) and overflows in the post-twiddle."""
    return edge_rows(batch, size >> 1, seed, 0.3 * F32_MAX)


def qmf_edge_bands(frames: int, s: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(low, high f32 [frames, s], delay f32 [46]) for `qmf_synthesis_exact`.

    low and high follow `edge_rows` with different seeds; in every other
    frame of the last pattern both bands are +-F32_MAX with the signs of a
    synthesis window, so one merged stream is +-F32_MAX (finite) and its
    tap sum, about 1.8 * F32_MAX in f64, rounds to inf."""
    from carta1_tpu_torch.constants import QMF_EVEN, QMF_ODD

    low = edge_rows(frames, s, seed, F32_MAX)
    high = edge_rows(frames, s, seed + 3, F32_MAX)
    for r in range(frames):
        if (r + seed) % PATTERNS == PATTERNS - 1 and r % 2:
            odd = r % 4 == 3                                   # the odd stream is 0.5 * (low - high)
            signs = np.where((QMF_ODD if odd else QMF_EVEN) < 0, -1.0, 1.0).astype(np.float32)
            low[r] = F32_MAX * np.resize(signs, s)
            high[r] = -low[r] if odd else low[r]
    delay = edge_rows(1, 46, seed + 5, F32_MAX)[0]
    return low, high, delay


def qmf_edge_work(frames: int, s: int, seed: int) -> np.ndarray:
    """f32 [frames, 46 + 2s]: the halo-prefixed merged stream `qmf_taps`
    takes, built from `qmf_edge_bands` as the decoder builds it.  Frames
    shorter than the halo (2s < 46) cannot chain; each then gets a halo of
    its own from `edge_rows`."""
    from carta1_tpu_torch.constants import QMF_DELAY

    low, high, delay = qmf_edge_bands(frames, s, seed)
    lv, hv = low.astype(np.float64), high.astype(np.float64)
    merged = np.stack([0.5 * (lv + hv), 0.5 * (lv - hv)], axis=-1).astype(np.float32).reshape(frames, 2 * s)
    if 2 * s >= QMF_DELAY:
        halo = np.concatenate([delay[None], merged[:-1, -QMF_DELAY:]])
    else:
        halo = edge_rows(frames, QMF_DELAY, seed + 5, F32_MAX)
    return np.concatenate([halo, merged], axis=1)
