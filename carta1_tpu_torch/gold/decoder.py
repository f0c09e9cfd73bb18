"""The exact decoder's names in the exact engine.

The port's decoder (`pipeline/decoder.decode_step`, kernels K1 and K2) is
already f32-bitwise equal to `carta1_tpu/gold/decoder.py`
`gold_decode_frames`, so the exact engine decodes with it.
"""

from __future__ import annotations

from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.pipeline.decoder import decode_frames, decoder_init_state

__all__ = ["decoder_init_state", "gold_decode_frames"]


def gold_decode_frames(fd: FrameData, state: dict | None = None, device=None, plain: bool = False):
    """Decode FrameData -> (pcm f32 [..., F, 512], new state) on `device`
    (default: the card), bit-identical to the gold engine."""
    return decode_frames(fd, state, device=device, plain=plain)
