"""The exact engine's transforms: MDCT, IMDCT, overlap-add and the QMF.

The port of `carta1_tpu/gold/transforms.py`: each function reproduces the
reference's arithmetic bit for bit on f32 data (f64 compute, an f32 store
at each point the JavaScript stores into a Float32Array).  Gold stores in
its input's dtype, so that f64 data gives the exact linear operators; here
the data is f32, as the reference's stores are, and another dtype raises.
The exact f64 operators are `mdct_basis` / `imdct_basis` (NumPy, from
`tables.py`).

On the card the transforms run on the hand kernels that compute them on
the codec's paths: `mdct_js` / `mdct` on K6 (`ops/fftjs_kernels.py`),
`imdct_js` / `imdct` on K1 (`ops/imdct_kernels.py`) and the decoder's
signed gather of its middle half (`ops/exact_decode.imdct_exact`), and
`qmf_synthesis_stream` on K2 and `qmf_analysis_stream` on K8 (both
`ops/qmf_kernels.py`).  A transform's scale is a sincos table the kernel
reads, so any scale runs on the same kernel; the sizes are the
reference's instances (64, 256, 512; mdct.js:215-221).
For a CPU tensor, or with `plain=True`, the kernels' plain versions run:
separate PyTorch ops, each of which rounds once.  `overlap_add_js` is the
decoder's `exact_decode.overlap_add_exact`, which has no kernel.

`mdct_js_plain` and `mdct_js_masked_plain` are the plain versions of
kernel K6's MDCT entries; `mdct_masked` is the encoder's short MDCT.

Parity: codec/transforms/mdct.js, codec/transforms/qmf.js.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.gold.fftjs import fft_js
from carta1_tpu_torch.ops.common import halo_prefix
from carta1_tpu_torch.ops.exact_decode import imdct_exact, overlap_add_exact
from carta1_tpu_torch.ops.qmf_kernels import qmf_analysis_taps, qmf_analysis_taps_plain, qmf_taps, qmf_taps_plain
from carta1_tpu_torch.tables import IMDCT_SCALES, MDCT_SCALES, imdct_basis, mdct_basis, mdct_tables

__all__ = [
    "IMDCT_SCALES", "MDCT_SCALES", "imdct", "imdct_basis", "imdct_js", "mdct", "mdct_basis", "mdct_js",
    "mdct_masked", "overlap_add_js", "qmf_analysis_stream", "qmf_synthesis_stream",
]

# output pairs per row of K2's work in `qmf_synthesis_stream`: the widest
# row the decoder gives K2 (a high band frame), [rows, 46 + 512]
QMF_ROW_PAIRS = 256


def _check(x: torch.Tensor, name: str, size: int | None = None, width: int | None = None) -> None:
    """Raise unless x is f32, `size` one of the reference's transform
    sizes and the last axis `width` samples."""
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: takes f32 data (the reference's Float32Array stores), got {x.dtype}")
    if size is not None and size not in MDCT_SCALES:
        raise ValueError(f"{name}: size must be one of {tuple(MDCT_SCALES)}, got {size}")
    if width is not None and (x.dim() == 0 or x.shape[-1] != width):
        raise ValueError(f"{name}: need [..., {width}] data at size {size}, got {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _mdct_indices(size: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Index tensors of the pre-FFT butterfly's two regions (mdct.js:70-96),
    for one size."""
    half, quarter = size >> 1, size >> 2
    n34 = 3 * quarter
    i1 = np.arange(0, quarter, 2)
    i2 = np.arange(quarter, half, 2)
    idx = {
        "a1": n34 - 1 - i1, "b1": n34 + i1, "c1": quarter + i1, "d1": quarter - 1 - i1,
        "a2": n34 - 1 - i2, "b2": i2 - quarter, "c2": quarter + i2, "d2": 5 * quarter - 1 - i2,
        "i": np.concatenate([i1, i2]),
    }
    return {k: torch.from_numpy(v.astype(np.int64)).to(device) for k, v in idx.items()}


@functools.lru_cache(maxsize=None)
def _mdct_sincos(size: int, scale: float | None, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mdct_tables(size, scale)[0].copy()).to(device)


def mdct_js_plain(x: torch.Tensor, size: int, scale: float | None = None) -> torch.Tensor:
    """Forward MDCT (mdct.js:54-122) at the reference encoder's scale or at
    `scale`: f32 [..., size] -> f32 [..., size/2].  Pre-FFT butterfly over
    two regions, `fft_js` of size/4 points, post-twiddle, each stored to f32."""
    if size not in MDCT_SCALES:
        raise ValueError(f"mdct size must be one of {tuple(MDCT_SCALES)}, got {size}")
    half = size >> 1
    t = _mdct_indices(size, x.device)
    tbl, i = _mdct_sincos(size, scale, x.device), t["i"]
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


def mdct_js_masked_plain(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The MDCT of size 64 of the rows of f32 [B, 64] whose bool [B] flag
    is set, +0 in every other row: f32 [B, 32]."""
    return torch.where(active.unsqueeze(-1), mdct_js_plain(x, 64), 0.0)


def mdct_js(x: torch.Tensor, size: int, scale: float | None, plain: bool = False) -> torch.Tensor:
    """Forward MDCT (mdct.js:54-122) of size 64, 256 or 512 at `scale`
    (None: the reference encoder's, `MDCT_SCALES`): f32 [..., size] ->
    [..., size/2].  Kernel K6's wrapper (its plain version for a CPU
    tensor), or the plain version with `plain=True`."""
    _check(x, "mdct_js", size, size)
    if plain:
        return mdct_js_plain(x, size, scale)
    from carta1_tpu_torch.ops import fftjs_kernels   # it imports this module's plain versions

    flat = x.reshape(-1, size).contiguous()
    return fftjs_kernels.mdct_js(flat, size, scale).reshape(*x.shape[:-1], size >> 1)


def mdct(x: torch.Tensor, size: int, plain: bool = False) -> torch.Tensor:
    """The reference encoder's MDCT instance of `size` (mdct.js:215-221):
    f32 [..., size] -> [..., size/2], on kernel K6."""
    return mdct_js(x, size, None, plain)


def imdct_js(x: torch.Tensor, size: int, scale: float | None = None, plain: bool = False) -> torch.Tensor:
    """Inverse MDCT (mdct.js:139-211) of size 64, 256 or 512 at `scale`
    (None: `size`, gold's default): f32 [..., size/2] -> [..., size].
    Kernel K1 computes the middle half, and the rest of the output is the
    signed gather of it that gold's scatter makes (its plain version for a
    CPU tensor, or with `plain=True`)."""
    _check(x, "imdct_js", size, size >> 1)
    return imdct_exact(x, size, plain=plain, scale=float(size) if scale is None else scale)


def imdct(x: torch.Tensor, size: int, plain: bool = False) -> torch.Tensor:
    """The reference decoder's IMDCT instance of `size` (`IMDCT_SCALES`):
    f32 [..., size/2] -> [..., size], on kernel K1."""
    _check(x, "imdct", size, size >> 1)
    return imdct_exact(x, size, plain=plain)


def overlap_add_js(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """Windowed cross-fade (mdct.js:230-245) with WINDOW_SHORT: f32
    [..., n] x2 -> [..., 2n], n at most 16 (the codec's is 16)."""
    _check(prev, "overlap_add_js")
    _check(curr, "overlap_add_js")
    if prev.shape != curr.shape or prev.dim() == 0 or not 0 < prev.shape[-1] <= C.MDCT_TAIL_WINDOW_SIZE:
        raise ValueError(f"overlap_add_js: need prev and curr of one shape [..., n], 0 < n <= "
                         f"{C.MDCT_TAIL_WINDOW_SIZE}, got {tuple(prev.shape)} and {tuple(curr.shape)}")
    return overlap_add_exact(prev, curr)


def mdct_masked(x: torch.Tensor, active: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """f32 [..., 64], bool [...] -> [..., 32]: the MDCT of size 64 where
    `active`, zeros elsewhere; kernel K6's masked entry (its plain version
    for a CPU tensor), or the plain version with `plain=True`."""
    flat, mask = x.reshape(-1, 64).contiguous(), active.reshape(-1).contiguous()
    if plain:
        out = mdct_js_masked_plain(flat, mask)
    else:
        from carta1_tpu_torch.ops import fftjs_kernels

        out = fftjs_kernels.mdct_js_masked(flat, mask)
    return out.reshape(*x.shape[:-1], 32)


def qmf_analysis_stream(signal: torch.Tensor, delay: torch.Tensor, *,
                        plain: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-stream QMF analysis (qmf.js:19-50), chained over all frames.

    signal: f32 [..., N]; delay: f32 [..., 46] (the stream's carry).
    Returns (low [..., N/2], high [..., N/2], new delay [..., 46]).  The
    even and odd sums run over the 24 taps in the reference's order, in
    f64, one rounding per multiply and per add, for every output sample
    (kernel K8, its plain version for a CPU tensor or with `plain=True`);
    low = even + odd and high = even - odd are stored f32.  The new delay
    is the last 46 samples of delay and signal together (a view of
    `signal` where N >= 46)."""
    _check(signal, "qmf_analysis_stream")
    _check(delay, "qmf_analysis_stream")
    lead, n = signal.shape[:-1], signal.shape[-1]
    if delay.shape != (*lead, C.QMF_DELAY):
        raise ValueError(f"qmf_analysis_stream: need signal [..., N] and delay [..., {C.QMF_DELAY}], got "
                         f"{tuple(signal.shape)} and {tuple(delay.shape)}")
    rows = math.prod(lead)
    taps = qmf_analysis_taps_plain if plain else qmf_analysis_taps
    low, high = taps(signal.reshape(rows, n).contiguous(), delay.reshape(rows, C.QMF_DELAY).contiguous())
    if n >= C.QMF_DELAY:
        new_delay = signal[..., n - C.QMF_DELAY:]
    else:
        new_delay = torch.cat([delay[..., n:], signal], dim=-1)
    return low.reshape(*lead, n >> 1), high.reshape(*lead, n >> 1), new_delay


def qmf_synthesis_stream(low: torch.Tensor, high: torch.Tensor, delay: torch.Tensor,
                         plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-stream QMF synthesis (qmf.js:60-105), chained over all frames.

    low, high: f32 [..., S] (any S); delay: f32 [..., 46] (the stream's
    carry).  Returns (output [..., 2S], new delay [..., 46]).  The merged
    stream 0.5 (l + h), 0.5 (l - h) is stored f32 and cut into rows of
    `QMF_ROW_PAIRS` output pairs, each behind the 46 merged samples before
    it (`halo_prefix`, the first row behind `delay`); kernel K2 runs each
    output's 24 taps in order.  An output reads only its 48-sample window,
    so the rows give gold's result bit for bit; the last row is padded with
    zeros that no kept output reads.  The new delay is the last 46 samples
    of delay and merged stream together."""
    for t in (low, high, delay):
        _check(t, "qmf_synthesis_stream")
    lead, s = low.shape[:-1], low.shape[-1]
    if high.shape != low.shape or delay.shape != (*lead, C.QMF_DELAY):
        raise ValueError(f"qmf_synthesis_stream: need low and high [..., S] and delay [..., {C.QMF_DELAY}], got "
                         f"{tuple(low.shape)}, {tuple(high.shape)}, {tuple(delay.shape)}")
    lv, hv = low.double(), high.double()
    merged = torch.stack([(0.5 * (lv + hv)).float(), (0.5 * (lv - hv)).float()], dim=-1).reshape(*lead, 2 * s)
    new_delay = torch.cat([delay, merged], dim=-1)[..., -C.QMF_DELAY:].contiguous()
    rows = max(1, -(-s // QMF_ROW_PAIRS))
    padded = torch.nn.functional.pad(merged, (0, 2 * (rows * QMF_ROW_PAIRS - s)))
    work = halo_prefix(padded.reshape(*lead, rows, 2 * QMF_ROW_PAIRS), delay)
    taps = qmf_taps_plain if plain else qmf_taps
    out = taps(work.reshape(-1, work.shape[-1]).contiguous())
    return out.reshape(*lead, 2 * rows * QMF_ROW_PAIRS)[..., :2 * s].contiguous(), new_delay
