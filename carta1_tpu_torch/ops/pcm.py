"""Device-side PCM <-> int16 conversion.

Read direction (bin/cli.js:316-353): int16 -> f32 is `s / 32768`, exact in
f32 (15-bit integers over a power of two), so converting on the device
after an int16 upload is bitwise the host conversion at half the bytes.

Write direction of the reference (codec/io/processor.js:347-426): clamp to
[-1, 1], scale negatives by 32768 and positives by 32767, truncate toward
zero, all in f64.  With IEEE f64 on the card this is computed directly,
bitwise equal to the host conversion `carta1_tpu/io/wav.py`
`float_to_int16`.
"""

from __future__ import annotations

import torch

from carta1_tpu_torch.constants import WAV_PCM_MAX_NEGATIVE, WAV_PCM_MAX_POSITIVE


def int16_to_float(pcm_i16: torch.Tensor) -> torch.Tensor:
    """int16 -> f32, bitwise equal to `carta1_tpu/ops/pcm.py` `int16_to_float`."""
    return pcm_i16.to(torch.float32) / 32768.0


def float_to_int16(pcm: torch.Tensor) -> torch.Tensor:
    """f32 -> int16: f64 clip, x32768 or x32767, trunc."""
    x = pcm.double().clamp(-1.0, 1.0)
    scaled = torch.where(x < 0, x * WAV_PCM_MAX_NEGATIVE, x * WAV_PCM_MAX_POSITIVE)
    return scaled.trunc().to(torch.int16)
