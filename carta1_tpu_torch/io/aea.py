"""AEA container read, write and stereo (de)interleave (parity: codec/io/serialization.js:182-254,
codec/io/readers.js).

Layout: 2048-byte header -- magic 00 08 00 00, NUL-terminated ASCII title at
offset 4 (max 255 chars), uint32-LE total frame count at 260 (counts both
channels), channel-count byte at 264 -- followed by concatenated 212-byte
sound units, stereo interleaved L,R.  Trailing partial units are dropped on
read (readers.js:49-54).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from carta1_tpu_torch.constants import (
    AEA_CHANNEL_COUNT_OFFSET,
    AEA_FRAME_COUNT_OFFSET,
    AEA_HEADER_SIZE,
    AEA_MAGIC,
    AEA_TITLE_OFFSET,
    AEA_TITLE_SIZE,
    SOUND_UNIT_SIZE,
)


@dataclasses.dataclass
class AeaMetadata:
    title: str
    frame_count: int      # total across channels
    channel_count: int

    @property
    def frames_per_channel(self) -> int:
        return self.frame_count // max(self.channel_count, 1)


def make_header(title: str = "", frame_count: int = 0, channel_count: int = 1) -> bytes:
    header = bytearray(AEA_HEADER_SIZE)
    header[:4] = AEA_MAGIC
    title_bytes = title.encode("utf-8")[: AEA_TITLE_SIZE - 1]
    header[AEA_TITLE_OFFSET:AEA_TITLE_OFFSET + len(title_bytes)] = title_bytes
    header[AEA_FRAME_COUNT_OFFSET:AEA_FRAME_COUNT_OFFSET + 4] = int(frame_count).to_bytes(4, "little")
    header[AEA_CHANNEL_COUNT_OFFSET] = channel_count
    return bytes(header)


def parse_header(header: bytes) -> AeaMetadata:
    if len(header) != AEA_HEADER_SIZE:
        raise ValueError(f"Header must be {AEA_HEADER_SIZE} bytes")
    if header[:4] != AEA_MAGIC:
        raise ValueError("Invalid AEA file")
    raw_title = header[AEA_TITLE_OFFSET:AEA_TITLE_OFFSET + AEA_TITLE_SIZE]
    nul = raw_title.find(0)
    title = raw_title[: nul if nul >= 0 else AEA_TITLE_SIZE].decode("utf-8", errors="replace")
    frame_count = int.from_bytes(header[AEA_FRAME_COUNT_OFFSET:AEA_FRAME_COUNT_OFFSET + 4], "little")
    channel_count = header[AEA_CHANNEL_COUNT_OFFSET]
    return AeaMetadata(title=title, frame_count=frame_count, channel_count=channel_count)


def write_aea(path: str, units: np.ndarray, title: str = "", channel_count: int = 1) -> None:
    """units: uint8 [total_frames, 212], already channel-interleaved."""
    units = np.ascontiguousarray(units, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(make_header(title, units.shape[0], channel_count))
        f.write(units.tobytes())


def read_aea(path: str) -> tuple[AeaMetadata, np.ndarray]:
    """Returns (metadata, uint8 [total_frames, 212]); drops trailing partial
    units like the reference reader."""
    with open(path, "rb") as f:
        meta = parse_header(f.read(AEA_HEADER_SIZE))
        body = f.read()
    nframes = len(body) // SOUND_UNIT_SIZE
    units = np.frombuffer(body[: nframes * SOUND_UNIT_SIZE], dtype=np.uint8)
    return meta, units.reshape(nframes, SOUND_UNIT_SIZE)


def deinterleave_stereo(units: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[2F, 212] in L,R frame order -> ([F, 212], [F, 212])."""
    return units[0::2], units[1::2]


def interleave_stereo(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """[F, 212] x2 -> [2F, 212] in L,R frame order (processor.js:104-115)."""
    out = np.empty((left.shape[0] + right.shape[0], SOUND_UNIT_SIZE), np.uint8)
    out[0::2] = left
    out[1::2] = right
    return out
