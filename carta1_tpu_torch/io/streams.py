"""Bounded-memory streaming host IO: chunked WAV/AEA readers and writers
plus mid-stream checkpoints (the counterpart of `carta1_tpu/io/streams.py`,
byte for byte: a file or checkpoint written by either package is read by
the other).

  * WavStreamReader  -- header parse, then a positioned read of only the
    requested frame range, converted (16/24/32-bit, as `io.wav.read_wav`) or
    handed over raw (16-bit) for the conversion on the device.
  * WavStreamWriter  -- incremental 16-bit PCM writer; sizes patched on close;
    resumable at a sample.
  * AeaStreamWriter  -- incremental sound-unit writer; frame count patched on
    close; resumable at a unit.
  * AeaStreamReader  -- positioned reads of the unit table (partial trailing
    unit dropped, readers.js:49-54).
  * StreamCheckpoint -- atomic (tmp + rename) `.npz` of the frame offset, the
    per-channel stream state (`ch{n}__{key}`) and a JSON `__meta__`.

The readers keep no mapping of the file: a memory map of the whole input
keeps every page read so far in the process's resident set, so an
hour-long WAV (606 MB) grew the RSS of `encode_file` by its size
(`harness/stream_stress.py`).  Each reader holds its file open and reads a
request at its offset into one buffer that it reuses, so the resident set
stays at a chunk and a read costs one copy out of the page cache.  Close a
reader (or use it in a `with`) when done with it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np

from carta1_tpu_torch.constants import (
    AEA_FRAME_COUNT_OFFSET,
    AEA_HEADER_SIZE,
    SAMPLE_RATE,
    SAMPLES_PER_FRAME,
    SOUND_UNIT_SIZE,
    WAV_BYTES_PER_SAMPLE,
)
from carta1_tpu_torch.io import aea
from carta1_tpu_torch.io.wav import WavInfo, float_to_int16, parse_fmt, samples_to_float, wav_header

WAV_HEADER_SIZE = 44


class _PositionedReader:
    """A file held open, read at an offset into one buffer that grows to the
    largest request: no mapping and no new array per read."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb", buffering=0)
        self._buf = np.empty(0, np.uint8)

    def _read_at(self, offset: int, nbytes: int) -> np.ndarray:
        """Read-only uint8 [nbytes] of the file from `offset`, in the reader's
        buffer: valid until its next read."""
        if self._buf.size < nbytes:
            self._buf = np.empty(nbytes, np.uint8)
        view = memoryview(self._buf)[:nbytes]
        self._f.seek(offset)
        done = 0
        while done < nbytes:
            n = self._f.readinto(view[done:])
            if not n:
                raise ValueError(f"{self.path}: {done} bytes at offset {offset}, expected {nbytes}")
            done += n
        out = self._buf[:nbytes]
        out.flags.writeable = False
        return out

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WavStreamReader(_PositionedReader):
    """Chunked WAV reader: one positioned read per request (no whole-file
    read, no mapping).

    `read_frames(start, count)` returns f32 [channels, count*512], zero-padded
    past the end of the file like the reference's frame splitter
    (processor.js:225-258); `num_frames` is at least 1."""

    def __init__(self, path: str):
        super().__init__(path)
        try:
            self._parse(os.path.getsize(path))
        except Exception:
            self.close()
            raise

    def _parse(self, size: int) -> None:
        f = self._f
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("Not a RIFF/WAVE file")
        pos = 12
        fmt = None
        data_off = data_len = None
        while pos + 8 <= size:
            f.seek(pos)
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id = hdr[:4]
            chunk_size = int.from_bytes(hdr[4:8], "little")
            if chunk_id == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
            elif chunk_id == b"data":
                data_off, data_len = pos + 8, min(chunk_size, size - pos - 8)
            pos += 8 + chunk_size + (chunk_size & 1)
        if fmt is None or data_off is None:
            raise ValueError("Missing fmt/data chunk")
        channels, sample_rate, bit_depth = parse_fmt(fmt)
        self._bps = bit_depth // 8
        frame_bytes = channels * self._bps
        n = data_len // frame_bytes
        self.info = WavInfo(channels=channels, sample_rate=sample_rate, bit_depth=bit_depth, num_samples=n)
        self.num_frames = max(1, -(-n // SAMPLES_PER_FRAME))
        self._data_off = data_off

    def _span(self, start_frame: int, count: int) -> tuple[np.ndarray, int]:
        """(the raw bytes of frames [start, start + count) that the file
        holds, how many samples per channel they are)."""
        c = self.info.channels
        s0 = start_frame * SAMPLES_PER_FRAME
        s1 = min((start_frame + count) * SAMPLES_PER_FRAME, self.info.num_samples)
        navail = max(s1 - s0, 0)
        return self._read_at(self._data_off + s0 * c * self._bps, navail * c * self._bps), navail

    def read_frames_i16(self, start_frame: int, count: int) -> np.ndarray | None:
        """int16 [channels, count*512] zero-padded, or None if not 16-bit:
        raw samples for the conversion on the device (`ops.pcm.int16_to_float`
        is bitwise the host conversion) at half the upload bytes."""
        if self._bps != 2:
            return None
        raw, navail = self._span(start_frame, count)
        out = np.zeros((self.info.channels, count * SAMPLES_PER_FRAME), np.int16)
        out[:, :navail] = raw.view("<i2").reshape(navail, self.info.channels).T
        return out

    def read_frames(self, start_frame: int, count: int) -> np.ndarray:
        raw, navail = self._span(start_frame, count)
        out = np.zeros((self.info.channels, count * SAMPLES_PER_FRAME), np.float32)
        out[:, :navail] = samples_to_float(raw, 8 * self._bps).reshape(navail, self.info.channels).T
        return out


class WavStreamWriter:
    """Incremental 16-bit PCM WAV writer (sizes patched on close).

    With `resume_at_samples` (per channel) and an existing file, keeps the
    file's first samples and continues after them."""

    def __init__(self, path: str, channels: int, sample_rate: int = SAMPLE_RATE,
                 resume_at_samples: int | None = None):
        self.path = path
        self.channels = channels
        self.sample_rate = sample_rate
        if resume_at_samples is not None and os.path.exists(path):
            self._f = open(path, "r+b")
            self._f.seek(WAV_HEADER_SIZE + resume_at_samples * channels * WAV_BYTES_PER_SAMPLE)
            self._f.truncate()
            self._n = resume_at_samples
            return
        self._n = 0
        self._f = open(path, "wb")
        self._f.write(wav_header(channels, 0, sample_rate))

    def append(self, pcm: np.ndarray) -> None:
        """pcm: f32 [channels, n], converted with the reference's conversion."""
        self.append_i16(float_to_int16(np.atleast_2d(pcm)))

    def append_i16(self, int16: np.ndarray) -> None:
        """int16 [channels, n] already converted (`ops.pcm.float_to_int16` on
        the device is bitwise the host conversion), interleaved into one
        buffer and written through the buffer protocol."""
        int16 = np.atleast_2d(np.asarray(int16, np.int16))
        nch, n = int16.shape
        out = np.empty((n, nch), np.dtype("<i2"))
        for c in range(nch):
            out[:, c] = int16[c]
        self._f.write(memoryview(out).cast("B"))
        self._n += n

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        header = wav_header(self.channels, self._n, self.sample_rate)
        self._f.seek(4)
        self._f.write(header[4:8])
        self._f.seek(40)
        self._f.write(header[40:44])
        self._f.close()


class AeaStreamWriter:
    """Incremental sound-unit writer; frame count patched on close.

    `resume_at_frame` counts units of all channels."""

    def __init__(self, path: str, title: str = "", channel_count: int = 1, resume_at_frame: int | None = None):
        self.path = path
        self.channel_count = channel_count
        if resume_at_frame is not None and os.path.exists(path):
            self._f = open(path, "r+b")
            self._f.seek(AEA_HEADER_SIZE + resume_at_frame * SOUND_UNIT_SIZE)
            self._f.truncate()
            self._n = resume_at_frame
        else:
            self._f = open(path, "wb")
            self._f.write(aea.make_header(title, 0, channel_count))
            self._n = 0

    @property
    def frames_written(self) -> int:
        return self._n

    def append(self, units: np.ndarray) -> None:
        units = np.ascontiguousarray(units, dtype=np.uint8)
        self._f.write(memoryview(units).cast("B"))
        self._n += units.shape[0]

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.seek(AEA_FRAME_COUNT_OFFSET)
        self._f.write(int(self._n).to_bytes(4, "little"))
        self._f.close()


class AeaStreamReader(_PositionedReader):
    """Unit-table reader, one positioned read per request (drops trailing
    partial units)."""

    def __init__(self, path: str):
        super().__init__(path)
        try:
            self.meta = aea.parse_header(self._f.read(AEA_HEADER_SIZE))
        except Exception:
            self.close()
            raise
        body = os.path.getsize(path) - AEA_HEADER_SIZE
        self.num_units = body // SOUND_UNIT_SIZE

    def read_units(self, start: int, count: int) -> np.ndarray:
        """Read-only uint8 [count, 212] (fewer past the end), in the reader's
        buffer: valid until its next read."""
        count = max(0, min(count, self.num_units - start))
        raw = self._read_at(AEA_HEADER_SIZE + start * SOUND_UNIT_SIZE, count * SOUND_UNIT_SIZE)
        return raw.reshape(count, SOUND_UNIT_SIZE)


@dataclasses.dataclass
class StreamCheckpoint:
    """Atomic (frame offset, per-channel stream state, metadata) snapshot.

    `state` is a list of per-channel dicts of NumPy arrays.  Writing is
    tmp + rename, so a crash never leaves a torn checkpoint."""

    path: str

    def save(self, frame_offset: int, state: list[dict[str, np.ndarray]], extra: dict | None = None) -> None:
        arrays: dict[str, np.ndarray] = {}
        for ch, st in enumerate(state):
            for k, v in st.items():
                arrays[f"ch{ch}__{k}"] = np.asarray(v)
        meta = {"frame_offset": int(frame_offset), "channels": len(state), **(extra or {})}
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> tuple[int, list[dict[str, np.ndarray]], dict] | None:
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            state = [dict() for _ in range(meta["channels"])]
            for key in z.files:
                if key == "__meta__":
                    continue
                ch, name = key.split("__", 1)
                state[int(ch[2:])][name] = z[key]
        return meta["frame_offset"], state, meta

    def remove(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
