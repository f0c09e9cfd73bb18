"""Bit-exact batched decoder ops.

Every function reproduces the reference decoder's f64-compute / f32-store
arithmetic at the bit level, like `carta1_tpu/ops/exact_decode.py`.  The
JAX package needs f32 error-free expansions for that (the TPU has no IEEE
f64); here each function mirrors the gold engine (`carta1_tpu/gold/`)
operation for operation in f64, with an f32 rounding at each store point:

  * dequantize_exact   -- RN32((q*sf)/range)        (quantization.js:65-78)
  * imdct_exact        -- kernel K1                 (mdct.js:139-211, fft.js:14-68)
  * overlap_add_exact  -- windowed cross-fade       (mdct.js:230-245)
  * qmf_synthesis_exact-- kernel K2                 (qmf.js:60-105)

Plain PyTorch ops never fuse a multiply with an add (each op is its own
kernel), so the elementwise f64 code rounds exactly where gold does.  The
`plain` flag of the kernel-backed functions runs the kernels' plain
PyTorch versions on any device: the yardstick the CUDA kernels are held
against.  The main path never sets it.

Frames ride axis -2; any leading axes (channels) batch along.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import profiling
from carta1_tpu_torch.ops.coding import quant_range
from carta1_tpu_torch.ops.common import halo_prefix, shift_frames
from carta1_tpu_torch.ops.imdct_kernels import imdct_mid, imdct_mid_plain
from carta1_tpu_torch.ops.qmf_kernels import qmf_taps, qmf_taps_plain


@functools.lru_cache(maxsize=None)
def _f64(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(getattr(C, name), np.float64).copy()).to(device)


# ---------------------------------------------------------------------------
# Dequantization (quantization.js:65-78, gold/coding.py dequantize_js)
# ---------------------------------------------------------------------------
def dequantize_exact(quantized: torch.Tensor, sf_idx: torch.Tensor, word_len: torch.Tensor) -> torch.Tensor:
    """int32 [..., 52, 20] -> f32: RN32(RN64(RN64(q * sf) / range))."""
    rng = quant_range(word_len)
    active = (rng > 0) & (sf_idx > 0)
    scale = torch.where(active, _f64("SCALE_FACTORS", quantized.device)[sf_idx.long()], 0.0)
    d = torch.where(rng > 0, rng, 1).double()
    return (quantized.double() * scale.unsqueeze(-1) / d.unsqueeze(-1)).float()


# ---------------------------------------------------------------------------
# IMDCT (mdct.js:139-211)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _full_from_mid(size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(index into the middle half, negate?) for each of the size outputs.

    Gold's post-twiddle scatter (gold/transforms.py imdct_js) writes each
    r1[i] and i1[i] twice, once inside the middle half (r1[i] at
    half-1-2i, i1[i] at 2i) and once outside it, sometimes negated; so the
    full output is a signed gather of the middle half."""
    q = size >> 2
    r1_at = lambda i: 2 * q - 1 - 2 * i  # noqa: E731  -- r1[i]'s place in the middle half
    i1_at = lambda i: 2 * i  # noqa: E731
    idx = np.full(size, -1, np.int64)
    neg = np.zeros(size, bool)
    for i in range(q // 2):
        i2 = 2 * i
        idx[3 * q - 1 - i2], idx[3 * q + i2] = r1_at(i), r1_at(i)
        idx[q + i2], idx[q - 1 - i2] = i1_at(i), i1_at(i)
        neg[q - 1 - i2] = True
    for i in range(q // 2, q):
        j = 2 * i
        idx[3 * q - 1 - j], idx[j - q] = r1_at(i), r1_at(i)
        idx[q + j], idx[5 * q - 1 - j] = i1_at(i), i1_at(i)
        neg[j - q] = True
    assert (idx >= 0).all()
    return torch.from_numpy(idx).to(device), torch.from_numpy(neg).to(device)


def imdct_exact(x: torch.Tensor, size: int, mid: bool = False, plain: bool = False,
                scale: float | None = None) -> torch.Tensor:
    """[..., size/2] f32 spectra -> [..., size] f32, bit-identical to
    gold.transforms.imdct (mdct.js:139-211 with the reference scales), or
    to gold.transforms.imdct_js at another `scale`.

    `mid=True` returns only the middle half [size/4, 3size/4), the only
    region the decoder's overlap assembly reads; the kernel computes just
    that, and the full output is a signed gather of it."""
    half = size >> 1
    lead = x.shape[:-1]
    core = imdct_mid_plain if plain else imdct_mid
    out = core(x.reshape(-1, half).contiguous(), size, scale)
    if not mid:
        idx, neg = _full_from_mid(size, x.device)
        g = out[:, idx]
        out = torch.where(neg, -g, g)
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# Overlap-add (mdct.js:230-245, gold/transforms.py overlap_add_js)
# ---------------------------------------------------------------------------
def overlap_add_exact(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """[..., t] x2 -> [..., 2t], bit-identical to gold overlap_add_js; the
    codec's t is 16 (t <= 16)."""
    t = prev.shape[-1]
    w = _f64("WINDOW_SHORT", prev.device)
    w1, w2 = w[:t], w[t:2 * t].flip(0)       # w1[i] = w[i], w2[i] = w[2t-1-i]
    p = prev.double()
    c = curr.flip(-1).double()               # c[i] = curr[t-1-i]
    lo = (p * w2 - c * w1).float()
    hi = (p * w1 + c * w2).float()
    return torch.cat([lo, hi.flip(-1)], dim=-1)


# ---------------------------------------------------------------------------
# QMF synthesis (qmf.js:60-105, gold/transforms.py qmf_synthesis_stream)
# ---------------------------------------------------------------------------
def qmf_synthesis_exact(
    low: torch.Tensor, high: torch.Tensor, delay: torch.Tensor, plain: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """low, high: [..., F, S]; delay: [..., 46].  Returns (out [..., F, 2S], new_delay).

    Bit-identical to gold qmf_synthesis_stream chained over the frames:
    the merged stream 0.5(l+h), 0.5(l-h) is stored f32, each frame gets
    the previous 46 merged samples as a halo, and kernel K2 runs the taps."""
    s = low.shape[-1]
    lv, hv = low.double(), high.double()
    merged = torch.stack([(0.5 * (lv + hv)).float(), (0.5 * (lv - hv)).float()], dim=-1)
    merged = merged.reshape(*low.shape[:-1], 2 * s)
    work = halo_prefix(merged, delay)                               # [..., F, 46 + 2S]
    taps = qmf_taps_plain if plain else qmf_taps
    out = taps(work.reshape(-1, work.shape[-1]).contiguous())
    return out.reshape(merged.shape), merged[..., -1, -C.QMF_DELAY:].clone()


# ---------------------------------------------------------------------------
# Per-band IMDCT + overlap assembly (decoder.js:116-330)
# ---------------------------------------------------------------------------
def _short_path(bands: list, is_short: torch.Tensor, inv_bufs: list, plain: bool) -> None:
    """Overwrite the short-mode frames of `inv_bufs` with their 16
    size-64 transforms (4 + 4 + 8 blocks over the three bands).

    Short frames are chosen by index, so a chunk pays the size-64
    transforms only for the frames that use them.  `torch.nonzero` and the
    per-band counts sync the host here, once per call: the span
    `carta1.decode.short_index`, which counts the short band-frames."""
    flags = is_short.reshape(-1, 3).T                                # [3, N]
    with profiling.span("carta1.decode.short_index") as sp:
        counts = flags.sum(dim=1).tolist()
        short = sum(counts)
        sp.add("short_band_frames", short)
        if short == 0:
            return
        rows = torch.split(torch.nonzero(flags)[:, 1], counts)      # band-major
    nb = C.MDCT_NUM_SHORT_BLOCKS
    blocks = []
    for b in range(3):
        blk = bands[b].reshape(-1, C.MDCT_BAND_SIZES[b])[rows[b]].reshape(-1, 32)
        blocks.append(blk if b == 0 else blk.flip(-1))               # mid/high: reversed per block
    inv64 = imdct_exact(torch.cat(blocks), 64, mid=True, plain=plain)   # [sum(nb*counts), 32]
    parts = torch.split(inv64, [nb[b] * counts[b] for b in range(3)])
    for b in range(3):
        flat = inv_bufs[b].view(-1, C.MDCT_BAND_SIZES[b])
        flat.index_copy_(0, rows[b], parts[b].reshape(-1, C.MDCT_BAND_SIZES[b]))


def imdct_bands_exact(
    coeffs: torch.Tensor, modes: torch.Tensor, tail_states: tuple, plain: bool = False
) -> tuple[list, list]:
    """All three bands' IMDCT + overlap assembly.

    coeffs [..., F, 512]; modes int32 [..., F, 3]; tail_states: three
    [..., 16] carries.  Returns (band outputs [[..., F, 128], [..., F, 128],
    [..., F, 256]], new tails).  Per band bit-identical to
    gold.decoder._imdct_band: long frames take the size-256/512 transform
    of the (mid/high reversed) band, short frames 4 or 8 size-64 blocks,
    and all 19 overlap-add windows of a frame run in one batched call."""
    t = C.MDCT_TAIL_WINDOW_SIZE
    sizes = C.MDCT_BAND_SIZES
    bands = [coeffs[..., 0:128], coeffs[..., 128:256], coeffs[..., 256:512]]

    # long path: mid/high spectra are reversed (utils.js:42-48)
    inv01 = imdct_exact(torch.stack([bands[0], bands[1].flip(-1)]), 256, mid=True, plain=plain)
    inv2 = imdct_exact(bands[2].flip(-1), 512, mid=True, plain=plain)
    inv_bufs = [inv01[0], inv01[1], inv2]
    _short_path(bands, modes != 0, inv_bufs, plain)

    tails, prev_tails = [], []
    for b in range(3):
        tl = inv_bufs[b][..., sizes[b] - t:]
        tails.append(tl)
        prev_tails.append(shift_frames(tl, tail_states[b]))

    # per band the long-path window plus nb short-block windows; the short
    # chain is not sequential (each block's `prev` is a slice of the
    # buffer, decoder.js:286-303), so all 19 windows batch on one axis
    prev_list, curr_list = [], []
    for b in range(3):
        nb = C.MDCT_NUM_SHORT_BLOCKS[b]
        buf = inv_bufs[b]
        prev_list.append(prev_tails[b].unsqueeze(-2))
        curr_list.append(buf[..., None, :t])
        prevs = [prev_tails[b]] + [buf[..., 32 * j - t:32 * j] for j in range(1, nb)]
        prev_list.append(torch.stack(prevs, dim=-2))
        curr_list.append(buf.reshape(*buf.shape[:-1], nb, 32)[..., :t])
    ola = overlap_add_exact(torch.cat(prev_list, dim=-2), torch.cat(curr_list, dim=-2))  # [..., F, 19, 32]

    outs = []
    off = 0
    for b in range(3):
        nb = C.MDCT_NUM_SHORT_BLOCKS[b]
        is_long = (modes[..., b] == 0).unsqueeze(-1)
        out_long = torch.cat([ola[..., off, :], inv_bufs[b][..., t:sizes[b] - t]], dim=-1)
        out_short = ola[..., off + 1:off + 1 + nb, :].reshape(out_long.shape)
        outs.append(torch.where(is_long, out_long, out_short))
        off += 1 + nb
    return outs, [tl[..., -1, :].clone() for tl in tails]
