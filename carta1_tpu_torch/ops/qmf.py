"""QMF filterbank and the band-stream delay.

The reference's per-frame delay-line filtering (codec/transforms/qmf.js) is
a 48-tap stride-2 correlation over [delay; signal]; batched over frames it
is one f32 `conv1d` with a 46-sample inter-frame halo, as in
`carta1_tpu/ops/qmf.py`: analysis emits (low, high) as its two output
channels, synthesis interleaves the even and odd phases of one
two-channel conv.  TF32 is off for cuDNN (package `__init__`), so the
products are full f32.

`qmf_synthesis` is the fast decoder's; the exact synthesis filterbank is
`ops.exact_decode.qmf_synthesis_exact` (kernel K2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops.common import halo_prefix


@functools.lru_cache(maxsize=None)
def _analysis_kernel(device: torch.device) -> torch.Tensor:
    """[2, 1, 48]: low[i] = sum_t work[2i+t] * W[47-t]; high the same with
    odd t positive and even t negative (qmf.js:32-45)."""
    return torch.from_numpy(np.stack([C.QMF_KERNEL_LOW, C.QMF_KERNEL_HIGH])[:, None, :]).to(device)


@functools.lru_cache(maxsize=None)
def _synthesis_kernel(device: torch.device) -> torch.Tensor:
    """[2, 1, 48] (qmf.js:88-101): out[2i] = sum_j work[2i + 2j + 1] * ODD[j],
    out[2i + 1] = sum_j work[2i + 2j] * EVEN[j]."""
    k = np.zeros((2, 1, C.QMF_TAPS), np.float32)
    k[0, 0, 1::2] = C.QMF_ODD
    k[1, 0, 0::2] = C.QMF_EVEN
    return torch.from_numpy(k).to(device)


def qmf_analysis(x: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [..., F, L] one stream chunk as frames; delay: [..., 46] stream carry.

    Returns (low [..., F, L/2], high [..., F, L/2], new_delay [..., 46])."""
    work = halo_prefix(x, delay)                                        # [..., F, 46 + L]
    out = torch.nn.functional.conv1d(
        work.reshape(-1, 1, work.shape[-1]), _analysis_kernel(x.device), stride=2
    )                                                                   # [N, 2, L/2]
    out = out.reshape(*x.shape[:-1], 2, x.shape[-1] // 2)
    return out[..., 0, :], out[..., 1, :], x[..., -1, -C.QMF_DELAY:].clone()


def qmf_synthesis(low: torch.Tensor, high: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """low, high: [..., F, S]; delay: [..., 46].  Returns (out [..., F, 2S], new_delay [..., 46])."""
    s = low.shape[-1]
    merged = torch.stack([0.5 * (low + high), 0.5 * (low - high)], dim=-1).reshape(*low.shape[:-1], 2 * s)
    work = halo_prefix(merged, delay)                                   # [..., F, 46 + 2S]
    out = torch.nn.functional.conv1d(
        work.reshape(-1, 1, work.shape[-1]), _synthesis_kernel(low.device), stride=2
    )                                                                   # [N, 2, S]
    out = out.transpose(-1, -2).reshape(*low.shape[:-1], 2 * s)        # phases interleaved
    return out, merged[..., -1, -C.QMF_DELAY:].clone()


def delay_stream(x: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift a band stream right by len(delay) samples (the high-band
    alignment FIFO, encoder.js:84-90 / decoder.js:360-367).

    x: [..., F, L]; delay: [..., D].  Returns (shifted [..., F, L], new_delay [..., D])."""
    d = delay.shape[-1]
    return halo_prefix(x, delay)[..., : x.shape[-1]], x[..., -1, -d:].clone()
