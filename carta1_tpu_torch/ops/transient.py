"""Batched transient detection (parity: codec/analysis/transient.js).

The four spectral features reduce over the bin axis, vectorized over
frames; the previous frame's spectrum is a one-frame shift with a
stream-state halo.  f32 throughout, op for op `carta1_tpu/ops/transient.py`
(the gold engine keeps the reference's f64 semantics).
"""

from __future__ import annotations

import math

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops.common import shift_frames


def magnitude_spectrum(band: torch.Tensor, fft_size: int) -> torch.Tensor:
    """[..., F, L] -> positive-frequency magnitudes [..., F, fft_size // 2]
    (zero padded or cut to fft_size)."""
    spec = torch.fft.rfft(band, n=fft_size, dim=-1)[..., : fft_size // 2]
    return spec.abs().to(torch.float32)


def _flatness(m: torch.Tensor) -> torch.Tensor:
    valid = m > 1e-10
    n = valid.sum(dim=-1)
    n_safe = n.clamp(min=1)
    sum_log = torch.where(valid, m.clamp(min=1e-30).log(), 0.0).sum(dim=-1)
    sum_lin = torch.where(valid, m, 0.0).sum(dim=-1)
    geo = (sum_log / n_safe).exp()
    arith = sum_lin / n_safe
    return torch.where((n > 0) & (arith > 1e-10), geo / arith.clamp(min=1e-30), 0.0)


def _hf_ratio(m: torch.Tensor) -> torch.Tensor:
    mid = m.shape[-1] // 2
    low = (m[..., :mid] ** 2).sum(dim=-1)
    high = (m[..., mid:] ** 2).sum(dim=-1)
    total = low + high
    return torch.where(total > 0, high / total.clamp(min=1e-30), 0.0)


def transient_score(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Combined 4-feature score, [..., F, bins] x2 -> [..., F] (transient.js:44-226)."""
    flux = (cur - prev).clamp(min=0.0).sum(dim=-1)          # magnitudes are non-negative
    energy = (cur * cur).sum(dim=-1)
    norm = energy.sqrt()
    flux = flux / torch.where(norm == 0.0, 1e-6, norm)

    flat_change = (_flatness(cur) - _flatness(prev)).abs()
    hf_change = (_hf_ratio(cur) - _hf_ratio(prev)).abs()

    ce = energy.clamp(min=1e-10)
    pe = (prev * prev).sum(dim=-1).clamp(min=1e-10)
    energy_change = (10.0 * torch.log10(ce / pe)).clamp(min=0.0)

    return (
        flux
        + flat_change.sqrt()
        + torch.log1p(hf_change * 10.0) / math.log1p(10.0)
        + (energy_change / 30.0).clamp(max=1.0)
    ) / 4.0


def block_modes(
    bands: list[torch.Tensor], prev_specs: list[torch.Tensor], thresholds: tuple[float, float, float]
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Per-band transient detection -> block modes (encoder.js:126-145).

    bands: [..., F, 128], [..., F, 128], [..., F, 256]; prev_specs: the stream
    carries [..., 64], [..., 64], [..., 128].
    Returns (modes int32 [..., F, 3], new_prev_specs)."""
    cols, new_specs = [], []
    for band in range(3):
        spec = magnitude_spectrum(bands[band], C.TRANSIENT_FFT_SIZES[band])
        score = transient_score(spec, shift_frames(spec, prev_specs[band]))
        short = torch.full_like(score, max(band + 1, 2), dtype=torch.int32)
        cols.append(torch.where(score > thresholds[band], short, 0))
        new_specs.append(spec[..., -1, :].clone())
    return torch.stack(cols, dim=-1), new_specs
