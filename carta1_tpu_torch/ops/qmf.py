"""Band-stream helpers of the QMF stage.

The exact synthesis filterbank itself is `ops.exact_decode.qmf_synthesis_exact`
(kernel K2).
"""

from __future__ import annotations

import torch

from carta1_tpu_torch.ops.common import halo_prefix


def delay_stream(x: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift a band stream right by len(delay) samples (the high-band
    alignment FIFO, encoder.js:84-90 / decoder.js:360-367).

    x: [..., F, L]; delay: [..., D].  Returns (shifted [..., F, L], new_delay [..., D])."""
    d = delay.shape[-1]
    return halo_prefix(x, delay)[..., : x.shape[-1]], x[..., -1, -d:].clone()
