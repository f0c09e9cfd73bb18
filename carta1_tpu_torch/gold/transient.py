"""Transient detection with the reference's exact f64 semantics.

The port of `carta1_tpu/gold/transient.py` (codec/analysis/transient.js).
The reference accumulates every spectral feature as a sequential f64 sum
over the bins.  `torch.sum` and `torch.cumsum` choose their own order
(pairwise on the CPU, trees on the card), so here all the features'
summands are stacked into one tensor and summed in one left-to-right loop
over the bins: one add per bin for every feature and row at once.  The
transcendentals (log, exp, log10, log1p) are f64; log1p(10) is the host's.
"""

from __future__ import annotations

import numpy as np
import torch

_LOG1P_10 = float(np.log1p(10.0))


def _seqsums(summands: torch.Tensor) -> torch.Tensor:
    """[K, ..., bins] f64 -> [K, ...]: each row summed left to right, from 0."""
    acc = torch.zeros(summands.shape[:-1], dtype=torch.float64, device=summands.device)
    for column in summands.movedim(-1, 0).contiguous():          # bins first: each step reads one block
        acc += column
    return acc


def _flatness(sum_log: torch.Tensor, sum_lin: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Spectral flatness from its sums (transient.js:120-141)."""
    n_safe = n.clamp(min=1).double()
    geo = torch.exp(sum_log / n_safe)
    arith = sum_lin / n_safe
    flat = torch.where(arith > 1e-10, geo / torch.where(arith > 0, arith, 1.0), 0.0)
    return torch.where(n == 0, 0.0, flat)


def _hf_ratio(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """High-frequency energy share (transient.js:149-164)."""
    total = low + high
    return torch.where(total > 0, high / torch.where(total > 0, total, 1.0), 0.0)


def transient_score(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Combined transient score (transient.js:44-226).

    cur, prev: f32 [..., bins] magnitude spectra.  Returns f64 [...]."""
    c, p = cur.double(), prev.double()
    ac, ap = c.abs(), p.abs()
    bins = c.shape[-1]
    low_half = torch.arange(bins, device=c.device) < bins // 2
    diff = ac - ap
    valid_c, valid_p = ac > 1e-10, ap > 1e-10
    cc, pp = c * c, p * p
    summands = torch.stack([
        torch.where(diff > 0, diff, 0.0),                                 # 0 flux
        ac * ac,                                                          # 1 current energy (= c * c)
        torch.where(valid_c, torch.log(torch.where(valid_c, ac, 1.0)), 0.0),   # 2, 3 flatness of cur
        torch.where(valid_c, ac, 0.0),
        torch.where(valid_p, torch.log(torch.where(valid_p, ap, 1.0)), 0.0),   # 4, 5 flatness of prev
        torch.where(valid_p, ap, 0.0),
        torch.where(low_half, cc, 0.0), torch.where(low_half, 0.0, cc),   # 6, 7 low / high halves of cur
        torch.where(low_half, pp, 0.0), torch.where(low_half, 0.0, pp),   # 8, 9 of prev
        pp,                                                               # 10 previous energy
    ])
    (flux, cur_energy, log_c, lin_c, log_p, lin_p, lo_c, hi_c, lo_p, hi_p, prev_energy) = _seqsums(summands)

    # spectral flux, normalized by the current energy (transient.js:92-112)
    norm = torch.sqrt(cur_energy)
    flux = flux / torch.where(norm == 0.0, 1e-6, norm)
    n_c, n_p = torch.count_nonzero(valid_c, dim=-1), torch.count_nonzero(valid_p, dim=-1)
    flat_change = (_flatness(log_c, lin_c, n_c) - _flatness(log_p, lin_p, n_p)).abs()
    hf_change = (_hf_ratio(lo_c, hi_c) - _hf_ratio(lo_p, hi_p)).abs()
    # energy change in dB, increases only (transient.js:172-189)
    ce, pe = cur_energy.clamp(min=1e-10), prev_energy.clamp(min=1e-10)
    energy_change = (10.0 * torch.log10(ce / pe)).clamp(min=0.0)
    # combined score (transient.js:197-226)
    return (
        flux
        + torch.sqrt(flat_change)
        + torch.log1p(hf_change * 10.0) / _LOG1P_10
        + (energy_change / 30.0).clamp(max=1.0)
    ) / 4.0
