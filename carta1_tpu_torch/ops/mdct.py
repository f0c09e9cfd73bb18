"""Batched windowed forward MDCT as f32 matrix products.

The reference transforms each band per frame through an FFT-based MDCT with
explicit windowing buffers (codec/pipeline/encoder.js:163-341).  As in
`carta1_tpu/ops/mdct.py`, the window geometry and the spectral reversal are
folded into precomputed basis matrices (`tables.encoder_mdct_tables`), so
each band is two batched products (long and short path, selected per frame)
and the only coupling between frames is a 32-sample tail halo.  The JAX
package computes these products outside any Pallas kernel; here they are
`torch.matmul` in full f32 (TF32 is off, package `__init__`).
"""

from __future__ import annotations

import functools

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops.common import shift_frames
from carta1_tpu_torch.tables import encoder_mdct_tables


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in encoder_mdct_tables().items()}


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
