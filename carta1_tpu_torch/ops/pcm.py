"""Device-side f32 -> int16 PCM conversion.

Write direction of the reference (codec/io/processor.js:347-426): clamp to
[-1, 1], scale negatives by 32768 and positives by 32767, truncate toward
zero, all in f64.  With IEEE f64 on the card this is computed directly,
bitwise equal to the host conversion `carta1_tpu/io/wav.py`
`float_to_int16`.
"""

from __future__ import annotations

import torch

from carta1_tpu_torch.constants import WAV_PCM_MAX_NEGATIVE, WAV_PCM_MAX_POSITIVE


def float_to_int16(pcm: torch.Tensor) -> torch.Tensor:
    """f32 -> int16: f64 clip, x32768 or x32767, trunc."""
    x = pcm.double().clamp(-1.0, 1.0)
    scaled = torch.where(x < 0, x * WAV_PCM_MAX_NEGATIVE, x * WAV_PCM_MAX_POSITIVE)
    return scaled.trunc().to(torch.int16)
