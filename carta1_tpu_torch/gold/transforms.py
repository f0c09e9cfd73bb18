"""The exact encoder's forward transforms: MDCT and QMF analysis.

The port of the forward half of `carta1_tpu/gold/transforms.py`: each
function reproduces the reference's arithmetic bit for bit on f32 data
(f64 compute, an f32 store at each point the JavaScript stores into a
Float32Array), as separate PyTorch ops, each of which rounds once.  The
inverse transforms are the exact decoder's (`ops/exact_decode.py`).

`mdct_js_plain` is the plain version of kernel K6's MDCT entry
(`ops/fftjs_kernels.py`); `mdct` launches K6 for a tensor on the card.

Parity: codec/transforms/mdct.js, codec/transforms/qmf.js.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.gold.fftjs import fft_js
from carta1_tpu_torch.tables import MDCT_SCALES, mdct_tables


@functools.lru_cache(maxsize=None)
def _mdct_indices(size: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Index tensors of the pre-FFT butterfly's two regions (mdct.js:70-96)
    and the sincos table, for one size."""
    half, quarter = size >> 1, size >> 2
    n34 = 3 * quarter
    i1 = np.arange(0, quarter, 2)
    i2 = np.arange(quarter, half, 2)
    idx = {
        "a1": n34 - 1 - i1, "b1": n34 + i1, "c1": quarter + i1, "d1": quarter - 1 - i1,
        "a2": n34 - 1 - i2, "b2": i2 - quarter, "c2": quarter + i2, "d2": 5 * quarter - 1 - i2,
        "i": np.concatenate([i1, i2]),
    }
    out = {k: torch.from_numpy(v.astype(np.int64)).to(device) for k, v in idx.items()}
    out["sincos"] = torch.from_numpy(mdct_tables(size)[0].copy()).to(device)
    return out


def mdct_js_plain(x: torch.Tensor, size: int) -> torch.Tensor:
    """Forward MDCT (mdct.js:54-122) with the reference's scale: f32
    [..., size] -> f32 [..., size/2].  Pre-FFT butterfly over two regions,
    `fft_js` of size/4 points, post-twiddle, each stored to f32."""
    if size not in MDCT_SCALES:
        raise ValueError(f"mdct size must be one of {tuple(MDCT_SCALES)}, got {size}")
    half = size >> 1
    t = _mdct_indices(size, x.device)
    tbl, i = t["sincos"], t["i"]
    xv = x.double()
    q = len(t["a1"])
    c, s = tbl[i[:q]], tbl[i[:q] + 1]
    r = xv[..., t["a1"]] + xv[..., t["b1"]]
    s_ = xv[..., t["c1"]] - xv[..., t["d1"]]
    re1, im1 = (r * c + s_ * s).float(), (s_ * c - r * s).float()
    c, s = tbl[i[q:]], tbl[i[q:] + 1]
    r = xv[..., t["a2"]] - xv[..., t["b2"]]
    s_ = xv[..., t["c2"]] + xv[..., t["d2"]]
    re2, im2 = (r * c + s_ * s).float(), (s_ * c - r * s).float()

    re, im = fft_js(torch.cat([re1, re2], dim=-1), torch.cat([im1, im2], dim=-1))

    c, s = tbl[0::2], tbl[1::2]
    rev, imv = re.double(), im.double()
    out = torch.empty((*x.shape[:-1], half), dtype=torch.float32, device=x.device)
    out[..., 0::2] = (-rev * c - imv * s).float()
    out[..., 1::2] = (-rev * s + imv * c).float().flip(-1)        # out[half-1-2i]
    return out


def mdct(x: torch.Tensor, size: int, plain: bool = False) -> torch.Tensor:
    """f32 [..., size] -> [..., size/2]: kernel K6's wrapper (its plain
    version for a CPU tensor), or the plain version with `plain=True`."""
    if plain:
        return mdct_js_plain(x, size)
    from carta1_tpu_torch.ops import fftjs_kernels   # it imports this module's plain versions

    return fftjs_kernels.mdct_js(x.reshape(-1, size).contiguous(), size).reshape(*x.shape[:-1], size >> 1)


def qmf_analysis_stream(signal: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-stream QMF analysis (qmf.js:19-50), chained over all frames.

    signal: f32 [..., N]; delay: f32 [..., 46] (the stream's carry).
    Returns (low [..., N/2], high [..., N/2], new delay [..., 46]).  The
    even and odd sums run over the 24 taps in the reference's order, in
    f64, one rounding per multiply and per add, vectorized over every
    output sample; low = even + odd and high = even - odd are stored f32."""
    work = torch.cat([delay, signal], dim=-1)
    n_out = signal.shape[-1] >> 1
    wv = work.double()
    even = torch.zeros((*work.shape[:-1], n_out), dtype=torch.float64, device=work.device)
    odd = torch.zeros_like(even)
    for j in range(24):
        e0, o0 = 47 - 2 * j, 46 - 2 * j
        even += wv[..., e0:e0 + 2 * n_out - 1:2] * float(C.QMF_EVEN[j])
        odd += wv[..., o0:o0 + 2 * n_out - 1:2] * float(C.QMF_ODD[j])
    return (even + odd).float(), (even - odd).float(), work[..., -C.QMF_DELAY:]
