"""16-bit PCM WAV write (parity: codec/io/processor.js:347-426).

Takes int16 samples as the decoder emits them (`decode_units(...,
to_i16=True)`, whose conversion is `ops.pcm.float_to_int16`), and writes
them little-endian, channel-interleaved.
"""

from __future__ import annotations

import struct

import numpy as np

from carta1_tpu_torch.constants import SAMPLE_RATE, WAV_BITS_PER_SAMPLE, WAV_BYTES_PER_SAMPLE


def write_wav(path: str, pcm_i16: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """pcm_i16: int16 [channels, num_samples] (or [num_samples]) -> WAV file."""
    pcm = np.atleast_2d(np.asarray(pcm_i16))
    if pcm.dtype != np.int16:
        raise TypeError(f"write_wav takes int16 samples, got {pcm.dtype}")
    channels, n = pcm.shape
    interleaved = np.ascontiguousarray(pcm.T).astype("<i2")

    byte_rate = sample_rate * channels * WAV_BYTES_PER_SAMPLE
    block_align = channels * WAV_BYTES_PER_SAMPLE
    data_size = n * block_align
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, WAV_BITS_PER_SAMPLE))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(interleaved.tobytes())
