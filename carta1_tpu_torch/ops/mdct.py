"""Batched windowed MDCT / IMDCT and overlap-add as f32 matrix products.

The reference transforms each band per frame through an FFT-based MDCT with
explicit windowing buffers (codec/pipeline/encoder.js:163-341,
decoder.js:116-330).  As in `carta1_tpu/ops/mdct.py`, the window geometry,
the spectral reversal and the decoder's middle-half extraction are folded
into precomputed basis matrices (`tables.encoder_mdct_tables`,
`tables.decoder_imdct_tables`), so each band is two batched products (long
and short path, selected per frame) and the only coupling between frames
is a 32-sample (encoder) / 16-sample (decoder) tail halo.  The JAX package
computes these products outside any Pallas kernel; here they are
`torch.matmul` in full f32 (TF32 is off, package `__init__`).  The
decoder's half is the fast decoder's, within one int16 step of the
reference; the exact one is `ops.exact_decode` (kernel K1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops.common import shift_frames
from carta1_tpu_torch.tables import decoder_imdct_tables, encoder_mdct_tables

_TAIL = C.MDCT_TAIL_WINDOW_SIZE        # 16


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in encoder_mdct_tables().items()}


@functools.lru_cache(maxsize=None)
def _decoder_tables(device: torch.device) -> dict[str, torch.Tensor]:
    tables = {k: torch.from_numpy(v).to(device) for k, v in decoder_imdct_tables().items()}
    w = torch.from_numpy(C.WINDOW_SHORT.astype(np.float32)).to(device)              # [32]
    tables["w_up"], tables["w_lo"] = w[:_TAIL], w[_TAIL:].flip(0)                    # W[i], W[31 - i]
    return tables


def encoder_mdct_band(
    band: torch.Tensor, band_idx: int, modes: torch.Tensor, tail_state: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """band: [..., F, size]; modes: int32 [..., F]; tail_state: [..., 32], the
    raw band tail before this chunk.  Returns (coeffs [..., F, size], new_tail [..., 32])."""
    t = _tables(band.device)
    size = band.shape[-1]
    nb = C.MDCT_NUM_SHORT_BLOCKS[band_idx]

    tail_prev = shift_frames(band[..., size - 32:], tail_state)                  # [..., F, 32] raw
    long_cf = tail_prev @ t[f"long_ov{band_idx}"] + band @ t[f"long_main{band_idx}"]

    blocks = band.reshape(*band.shape[:-1], nb, 32)
    ov_blocks = torch.cat([tail_prev.unsqueeze(-2), blocks[..., :-1, :]], dim=-2)
    sov = t["short_ov_rev" if band_idx > 0 else "short_ov"]
    smain = t["short_main_rev" if band_idx > 0 else "short_main"]
    short_cf = (ov_blocks @ sov + blocks @ smain).reshape(band.shape)

    coeffs = torch.where((modes == 0).unsqueeze(-1), long_cf, short_cf)
    return coeffs, band[..., -1, size - 32:].clone()


def _overlap_add(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """Windowed cross-fade (mdct.js:230-245) in f32: [..., 16] x2 -> [..., 32]."""
    t = _decoder_tables(prev.device)
    c = curr.flip(-1)                                                            # c[i] = curr[15 - i]
    lo = prev * t["w_lo"] - c * t["w_up"]
    hi = prev * t["w_up"] + c * t["w_lo"]
    return torch.cat([lo, hi.flip(-1)], dim=-1)


def decoder_imdct_band(
    coeffs: torch.Tensor, band_idx: int, modes: torch.Tensor, tail_state: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """coeffs: [..., F, size] band spectra; modes: int32 [..., F]; tail_state:
    [..., 16].  Returns (band samples [..., F, size], new_tail [..., 16])."""
    t = _decoder_tables(coeffs.device)
    size = coeffs.shape[-1]
    nb = C.MDCT_NUM_SHORT_BLOCKS[band_idx]

    inv_long = coeffs @ t[f"long{band_idx}"]
    blocks = coeffs.reshape(*coeffs.shape[:-1], nb, 32)
    inv_short = (blocks @ t["short_rev" if band_idx > 0 else "short"]).reshape(coeffs.shape)
    is_long = (modes == 0).unsqueeze(-1)
    inv = torch.where(is_long, inv_long, inv_short)
    tail = inv[..., size - _TAIL:]
    prev_tail = shift_frames(tail, tail_state)                                   # [..., F, 16]

    # the short assembly's nb windows (decoder.js:263-297) in one batched
    # call: each block's `prev` is the one before it in the buffer, the
    # first block's the previous frame's tail; the long assembly's window
    # (decoder.js:203-232) is the first of them
    prevs = torch.stack([prev_tail] + [inv[..., 32 * j - _TAIL: 32 * j] for j in range(1, nb)], dim=-2)
    ola = _overlap_add(prevs, inv.reshape(*inv.shape[:-1], nb, 32)[..., :_TAIL])  # [..., F, nb, 32]
    out_long = torch.cat([ola[..., 0, :], inv[..., _TAIL: size - _TAIL]], dim=-1)
    out_short = ola.reshape(inv.shape)
    return torch.where(is_long, out_long, out_short), tail[..., -1, :].clone()
