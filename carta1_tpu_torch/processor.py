"""High-level decode API (parity: codec/io/processor.js AudioProcessor).

`decode_units` turns interleaved AEA sound units into PCM on the card:
each chunk is uploaded as raw 212-byte units, unpacked on the device (K3),
decoded bit-exactly (K1, K2), and optionally converted to int16 there.
Channels ride a leading batch axis and the stream state carries across
chunks, so chunking never changes a bit of the output.
"""

from __future__ import annotations

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.io import aea
from carta1_tpu_torch.ops.bitpack import unpack_frames
from carta1_tpu_torch.ops.pcm import float_to_int16
from carta1_tpu_torch.pipeline.decoder import decode_step, decoder_init_state

DEFAULT_CHUNK_FRAMES = 8192


def _decode_batch_dev(units: torch.Tensor, state: dict | None, to_i16: bool = False, plain: bool = False):
    """Decode one chunk already on the device.

    units: uint8 [C, F, 212].  Returns (pcm [C, F, 512] f32, or int16 with
    `to_i16`, on the device; new state)."""
    if state is None:
        state = decoder_init_state(units.device, units.shape[0])
    pcm, state = decode_step(unpack_frames(units, plain=plain), state, plain=plain)
    if to_i16:
        pcm = float_to_int16(pcm)
    return pcm, state


def decode_units(
    units: np.ndarray,
    channel_count: int,
    device=None,
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    to_i16: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Interleaved sound units uint8 [N, 212] -> PCM [channels, F*512] on `device`.

    `device=None` decodes on the card.  Odd stereo unit counts are padded
    with a silent unit (processor.js:201-211).  The result is f32, or int16
    with the reference's WAV conversion when `to_i16` is set.  `plain=True`
    runs the kernels' plain PyTorch versions (the kernels' yardstick)."""
    dev = resolve_device(device)
    units = np.ascontiguousarray(units, dtype=np.uint8)
    if channel_count not in (1, 2):
        raise ValueError(f"channel_count must be 1 or 2, got {channel_count}")
    if channel_count == 2 and units.shape[0] % 2 == 1:
        units = np.concatenate([units, C.SILENT_UNIT[None]])
    channels = [units] if channel_count == 1 else list(aea.deinterleave_stereo(units))
    stacked = np.stack(channels)                                      # [C, F, 212]
    nframes = stacked.shape[1]
    state = None
    outs = []
    for start in range(0, nframes, chunk_frames):
        chunk = torch.from_numpy(np.ascontiguousarray(stacked[:, start:start + chunk_frames])).to(dev)
        pcm, state = _decode_batch_dev(chunk, state, to_i16=to_i16, plain=plain)
        outs.append(pcm)
    if not outs:
        dtype = torch.int16 if to_i16 else torch.float32
        return torch.zeros((len(channels), 0), dtype=dtype, device=dev)
    return torch.cat(outs, dim=1).reshape(len(channels), -1)
