"""Chunk streaming with the codec state carried.

The port of `carta1_tpu/pipeline/streaming.py`: a stream cut into
equal chunks [nchunks, ..., chunk, 512] runs chunk by chunk through the
batched pipeline, the state of each chunk handed to the next, exactly the
reference's BufferPool role (codec/core/buffers.js:31-72).  The results
equal `encode_frames` / `decode_frames` over the same chunks, and
`encode_pcm` / `decode_units` with the same chunk size.

The JAX version is one `lax.scan`, to make one dispatch of many chunks;
here each chunk is its own dispatch (one program per chunk on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.ops.pcm import int16_to_float
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.pipeline.decoder import decode_frames
from carta1_tpu_torch.pipeline.encoder import encode_frames


def encode_stream(pcm_chunks, options: EncoderOptions | None = None, state: dict | None = None,
                  device=None) -> tuple[FrameData, dict]:
    """pcm_chunks: [nchunks, ..., chunk_frames, 512], f32 or raw int16
    samples (converted on the device) -> (FrameData with leading [nchunks,
    ..., chunk_frames] axes, final state), on `device` (default: the card)."""
    dev = resolve_device(device)
    if not isinstance(pcm_chunks, torch.Tensor):
        pcm_chunks = torch.from_numpy(np.ascontiguousarray(pcm_chunks))
    fields = []
    for chunk in pcm_chunks:
        chunk = chunk.to(dev)
        chunk = int16_to_float(chunk) if chunk.dtype == torch.int16 else chunk.to(torch.float32)
        fd, state = encode_frames(chunk, options, state, device=dev)
        fields.append(fd)
    return FrameData(*(torch.stack([getattr(fd, k) for fd in fields]) for k in FrameData.fields())), state


def decode_stream(fds: FrameData, state: dict | None = None, device=None) -> tuple[torch.Tensor, dict]:
    """fds: FrameData with leading [nchunks, ..., chunk_frames] axes -> (pcm
    [nchunks, ..., chunk_frames, 512] f32, final state), on `device`
    (default: the card)."""
    dev = resolve_device(device)
    outs = []
    for k in range(fds.n_bfu.shape[0]):
        pcm, state = decode_frames(fds[k], state, device=dev)
        outs.append(pcm)
    return torch.stack(outs), state


def chunk_frames_array(frames, chunk: int) -> tuple[np.ndarray, int]:
    """[..., F, 512] -> ([nchunks, ..., chunk, 512], valid frame count),
    zero-padding the tail chunk; the dtype is kept (f32, or raw int16)."""
    frames = np.asarray(frames)
    nframes = frames.shape[-2]
    nchunks = max(1, -(-nframes // chunk))
    lead = frames.shape[:-2]
    out = np.zeros((*lead, nchunks * chunk, C.SAMPLES_PER_FRAME), np.int16 if frames.dtype == np.int16 else np.float32)
    out[..., :nframes, :] = frames
    out = out.reshape(*lead, nchunks, chunk, C.SAMPLES_PER_FRAME)
    return np.ascontiguousarray(np.moveaxis(out, -3, 0)), nframes
