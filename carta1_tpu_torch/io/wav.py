"""WAV read and write with the reference's PCM conversions, on the host.

Read (bin/cli.js:316-353): 16/24/32-bit integer PCM, plain or
WAVE_FORMAT_EXTENSIBLE, to f32 by dividing by 32768 / 8388608 /
2147483648.  Write (codec/io/processor.js:347-426): 16-bit little-endian,
channel-interleaved; `float_to_int16` is the reference's conversion (clamp
to [-1, 1], scale negatives by 32768 and positives by 32767, truncate toward
zero, in f64), bitwise equal to `ops.pcm.float_to_int16` on the device.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from carta1_tpu_torch.constants import (
    SAMPLE_RATE,
    WAV_BITS_PER_SAMPLE,
    WAV_BYTES_PER_SAMPLE,
    WAV_PCM_MAX_NEGATIVE,
    WAV_PCM_MAX_POSITIVE,
)

WAV_FORMATS = (1, 0xFFFE)          # PCM, WAVE_FORMAT_EXTENSIBLE
WAV_DEPTHS = (16, 24, 32)


@dataclasses.dataclass
class WavInfo:
    channels: int
    sample_rate: int
    bit_depth: int
    num_samples: int  # per channel

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate


def float_to_int16(pcm: np.ndarray) -> np.ndarray:
    """f32 [-1, 1] -> int16 with the reference's asymmetric scale and truncation."""
    x = np.clip(pcm.astype(np.float64), -1.0, 1.0)
    scaled = np.where(x < 0, x * WAV_PCM_MAX_NEGATIVE, x * WAV_PCM_MAX_POSITIVE)
    return np.trunc(scaled).astype(np.int16)


def int16_to_float(pcm: np.ndarray) -> np.ndarray:
    return pcm.astype(np.float32) / np.float32(32768.0)


def samples_to_float(raw: np.ndarray, bit_depth: int) -> np.ndarray:
    """Little-endian integer sample bytes (uint8) -> f32 samples."""
    if bit_depth == 16:
        return raw.view("<i2").astype(np.float32) / 32768.0
    if bit_depth == 32:
        return raw.view("<i4").astype(np.float32) / 2147483648.0
    b = raw[: (len(raw) // 3) * 3].reshape(-1, 3).astype(np.int32)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = np.where(v > 0x7FFFFF, v - 0x1000000, v)
    return v.astype(np.float32) / 8388608.0


def parse_fmt(fmt: tuple) -> tuple[int, int, int]:
    """The 16-byte fmt chunk, unpacked -> (channels, sample rate, bit depth);
    raises on a format or depth the codec does not read."""
    audio_format, channels, sample_rate, _, _, bit_depth = fmt
    if audio_format not in WAV_FORMATS:
        raise ValueError(f"Unsupported WAV format code {audio_format}")
    if bit_depth not in WAV_DEPTHS:
        raise ValueError(f"Unsupported bit depth {bit_depth}")
    return channels, sample_rate, bit_depth


def read_wav(path: str) -> tuple[WavInfo, np.ndarray]:
    """Returns (info, f32 [channels, num_samples])."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm_bytes = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        chunk_size = int.from_bytes(data[pos + 4:pos + 8], "little")
        body = data[pos + 8:pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            pcm_bytes = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or pcm_bytes is None:
        raise ValueError("Missing fmt/data chunk")
    channels, sample_rate, bit_depth = parse_fmt(fmt)
    bps = bit_depth // 8
    raw = np.frombuffer(pcm_bytes, dtype=np.uint8)
    samples = samples_to_float(raw[: (len(raw) // bps) * bps], bit_depth)
    n = len(samples) // channels
    deinterleaved = samples[: n * channels].reshape(n, channels).T.copy()
    return WavInfo(channels=channels, sample_rate=sample_rate, bit_depth=bit_depth, num_samples=n), deinterleaved


def wav_header(channels: int, num_samples: int, sample_rate: int = SAMPLE_RATE) -> bytes:
    """The 44-byte header of a 16-bit PCM WAV file."""
    byte_rate = sample_rate * channels * WAV_BYTES_PER_SAMPLE
    block_align = channels * WAV_BYTES_PER_SAMPLE
    data_size = num_samples * block_align
    return (
        b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, WAV_BITS_PER_SAMPLE)
        + b"data" + struct.pack("<I", data_size)
    )


def write_wav(path: str, pcm: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """pcm: [channels, num_samples] (or [num_samples]) -> 16-bit PCM WAV.

    Float samples are converted with `float_to_int16`, as the JAX package's
    `write_wav` converts them; int16 samples (the decoder's, converted on
    the card) are written as they are."""
    pcm = np.atleast_2d(np.asarray(pcm))
    if pcm.dtype != np.int16:
        pcm = float_to_int16(pcm)
    channels, n = pcm.shape
    interleaved = np.ascontiguousarray(pcm.T).astype("<i2")
    with open(path, "wb") as f:
        f.write(wav_header(channels, n, sample_rate))
        f.write(interleaved.tobytes())
