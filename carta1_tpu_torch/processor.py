"""High-level transcode API (parity: codec/io/processor.js AudioProcessor).

`encode_pcm` turns PCM into interleaved AEA sound units on the card: each
chunk is uploaded as f32 or raw int16 frames, encoded (the allocator is
one launch of K4) and packed on the device, so only 212-byte units come
back.
`decode_units` turns interleaved AEA sound units into PCM on the card:
each chunk is uploaded as raw 212-byte units, unpacked on the device (K3),
decoded bit-exactly (K1, K2), and optionally converted to int16 there.
Channels ride a leading batch axis and the stream state carries across
chunks, so chunking never changes a bit of the output.

Engines, with the JAX package's names and default: `engine="tpu"` is the
batched encoder (`pipeline/encoder.py`, f32 transforms and the
measured-distortion allocator, kernel K4), which in the port runs on the
card; `engine="exact"` is the exact encoder (`gold/`: f64 transforms on
kernel K6 and the reference's heap allocator, kernel K5), whose units are
byte-equal to the reference JavaScript's (on non-finite input only as far
as the scale factors: `gold/encoder.py`).  Both decode with the bit-exact
decoder, so `engine` changes nothing there but its check.

`encode_pcm`, `decode_units`, `encode_file` and `decode_file` take the JAX
package's parameters first, in its order and with its defaults, so a
positional call written for `carta1_tpu` binds the same parameters here;
the port's own parameters (`device`, `plain`, `to_i16`) come after a bare
`*` and are keyword-only.

`encode_file` and `decode_file` stream files through the same chunks with
O(chunk) host memory: a reader that reads each chunk at its offset (and
maps nothing) feeds each chunk, and a chunk's result comes to the host one
chunk late (`_Lag`), so the host writes chunk k while the card computes
chunk k + 1.  With a checkpoint, the frame offset
and the stream state are saved atomically every few chunks (in the JAX
package's file format), and a killed run resumes byte-identically.
With a `mesh` (a tuple of devices, `parallel.sharding`), each chunk's
frames are split across it and the ordinary stream state is carried from
chunk to chunk into shard 0, so a mesh run writes the same bytes and the
same checkpoints as a run without one, and either resumes the other.
`encode_clips` encodes many independent clips as one batch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import profiling
from carta1_tpu_torch.convert import state_from_numpy, state_to_numpy
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.gold.encoder import exact_encode_step
from carta1_tpu_torch.io import aea
from carta1_tpu_torch.io.streams import AeaStreamReader, AeaStreamWriter, StreamCheckpoint, WavStreamReader, WavStreamWriter
from carta1_tpu_torch.ops.bitpack import pack_frames, unpack_frames
from carta1_tpu_torch.ops.pcm import float_to_int16, int16_to_float
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.parallel.sharding import decode_frames_sharded, encode_frames_sharded, make_mesh
from carta1_tpu_torch.pipeline.decoder import decode_step, decoder_init_state
from carta1_tpu_torch.pipeline.encoder import encode_step, encoder_init_state

DEFAULT_CHUNK_FRAMES = 8192
ENGINES = ("tpu", "exact")


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"Unknown engine: {engine}")


def pcm_to_frames(pcm: np.ndarray) -> np.ndarray:
    """[N] samples -> zero-padded [F, 512] (processor.js:225-258); int16
    stays int16 (raw WAV samples, converted on the device), anything else
    becomes f32."""
    n = pcm.shape[-1]
    nframes = max(1, -(-n // C.SAMPLES_PER_FRAME))
    out = np.zeros((nframes, C.SAMPLES_PER_FRAME), np.int16 if pcm.dtype == np.int16 else np.float32)
    out.reshape(-1)[:n] = pcm
    return out


def _encode_batch_dev(frames: torch.Tensor, options: EncoderOptions, state: dict | None, plain: bool = False,
                      engine: str = "tpu"):
    """Encode one chunk already on the device with `engine`; the units stay there.

    frames: [C, F, 512] f32, or int16 raw WAV samples, converted on the
    device (bitwise the host conversion, half the upload).  Returns (units
    uint8 [C, F, 212] on the device, new state)."""
    _check_engine(engine)
    with profiling.span("carta1.encode.step", frames):
        if state is None:
            state = encoder_init_state(frames.device, frames.shape[0])
        pcm = int16_to_float(frames) if frames.dtype == torch.int16 else frames.to(torch.float32)
        profiling.nan_check("encoder input PCM", pcm)
        if engine == "exact":
            fd, state = exact_encode_step(pcm, state, options, plain=plain)
        else:
            fd, state = encode_step(
                pcm, state, options.band_thresholds, options.allocation_bias, options.allocator, plain=plain
            )
        with profiling.span("carta1.encode.pack"):
            units = pack_frames(fd)
    return units, state


def encode_pcm(
    pcm: np.ndarray,
    options: EncoderOptions | None = None,
    engine: str = "tpu",
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    on_progress: Callable[[int, int], None] | None = None,
    *,
    device=None,
    plain: bool = False,
) -> np.ndarray:
    """pcm: f32 (or raw int16) [channels, N] -> interleaved sound units uint8 [F*C, 212].

    `device=None` encodes on the card.  Long inputs stream through
    fixed-size chunks with the stream state carried; the units of every
    chunk stay on the device until the end.  `engine` is "tpu" (the
    batched encoder) or "exact" (units byte-equal to the reference's; the
    module docstring; on non-finite input its units are specified only up
    to the scale factors).  `plain=True` runs the kernels' plain PyTorch
    versions (the kernels' yardstick).  `on_progress(done, total)` is
    called once per chunk, after the chunk is queued, with the frames
    queued so far and the frames in all, as the JAX package calls it; it
    waits for nothing on the card."""
    _check_engine(engine)
    dev = resolve_device(device)
    options = options or EncoderOptions()
    pcm = np.asarray(pcm)
    if pcm.ndim != 2 or pcm.shape[0] not in (1, 2):
        raise ValueError(f"encode_pcm: need PCM [channels, N] with 1 or 2 channels, got {pcm.shape}")
    frames = np.stack([pcm_to_frames(ch) for ch in pcm])              # [C, F, 512]
    nframes = frames.shape[1]
    state = None
    chunks = []
    for start in range(0, nframes, chunk_frames):
        chunk = torch.from_numpy(np.ascontiguousarray(frames[:, start:start + chunk_frames])).to(dev)
        units, state = _encode_batch_dev(chunk, options, state, plain=plain, engine=engine)
        chunks.append(units)
        if on_progress:
            on_progress(min(start + chunk_frames, nframes), nframes)
    units = torch.cat(chunks, dim=1).cpu().numpy()                    # [C, F, 212]
    if units.shape[0] == 1:
        return units[0]
    return aea.interleave_stereo(units[0], units[1])


def _decode_batch_dev(units: torch.Tensor, state: dict | None, to_i16: bool = False, plain: bool = False):
    """Decode one chunk already on the device.

    units: uint8 [C, F, 212].  Returns (pcm [C, F, 512] f32, or int16 with
    `to_i16`, on the device; new state)."""
    with profiling.span("carta1.decode.step", units):
        if state is None:
            state = decoder_init_state(units.device, units.shape[0])
        with profiling.span("carta1.decode.unpack"):
            fd = unpack_frames(units, plain=plain)
        pcm, state = decode_step(fd, state, plain=plain)
        profiling.nan_check("decoder PCM", pcm)
        if to_i16:
            pcm = float_to_int16(pcm)
    return pcm, state


def decode_units(
    units: np.ndarray,
    channel_count: int,
    engine: str = "tpu",
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    on_progress: Callable[[int, int], None] | None = None,
    *,
    device=None,
    to_i16: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Interleaved sound units uint8 [N, 212] -> PCM [channels, F*512] on `device`.

    `device=None` decodes on the card.  Odd stereo unit counts are padded
    with a silent unit (processor.js:201-211).  The result is f32, or int16
    with the reference's WAV conversion when `to_i16` is set.  Both engines
    decode bit-exactly, with the same decoder.  `plain=True` runs the
    kernels' plain PyTorch versions (the kernels' yardstick).
    `on_progress(done, total)` is called once per chunk, after it is
    queued, with the frames per channel queued so far and in all (a
    stereo stream's padding unit counted), as the JAX package calls it."""
    _check_engine(engine)
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
        if on_progress:
            on_progress(min(start + chunk_frames, nframes), nframes)
    if not outs:
        dtype = torch.int16 if to_i16 else torch.float32
        return torch.zeros((len(channels), 0), dtype=dtype, device=dev)
    return torch.cat(outs, dim=1).reshape(len(channels), -1)


def _encode_chunk_sharded(frames: torch.Tensor, options: EncoderOptions, state: dict | None, mesh: tuple):
    """Encode one host chunk [C, n, 512] (raw int16 or f32) with its frames
    split across `mesh`.  Returns (units uint8 [C, n, 212] on mesh[0], the
    stream state after the chunk).

    The JAX package (`carta1_tpu/processor.py` `_encode_chunk_sharded`)
    carries the chunk's last two raw frames instead and re-encodes them as
    a prefix; here the stream state itself is carried, as without a mesh."""
    fd, state = encode_frames_sharded(frames, options, mesh, state)
    return pack_frames(fd), state


def _decode_chunk_sharded(units: torch.Tensor, state: dict | None, mesh: tuple):
    """Decode one host chunk of units uint8 [C, n, 212]: unpacked on mesh[0]
    (K3), its frames split across `mesh`.  Returns (int16 [C, n, 512] on
    mesh[0], the stream state after the chunk)."""
    fd = unpack_frames(units.to(mesh[0]))
    pcm, state = decode_frames_sharded(fd, mesh, state)
    profiling.nan_check("decoder PCM", pcm)
    return float_to_int16(pcm), state


def _placement(mesh, device, plain: bool) -> tuple[tuple | None, torch.device]:
    """(the mesh or None, the device the chunks' results land on)."""
    if mesh is None:
        return None, resolve_device(device)
    if device is not None or plain:
        raise ValueError("a mesh run takes no `device` (its results land on the mesh's first device) and no `plain`")
    mesh = make_mesh(mesh)
    return mesh, mesh[0]


@dataclasses.dataclass
class TranscodeResult:
    frames: int
    channels: int
    samples: int
    duration: float


def _state_to_list(state: dict | None, nch: int) -> list[dict[str, np.ndarray]]:
    """Stream state {key: [C, n] tensor} -> per-channel NumPy dicts (the
    checkpoint's form, the gold engine's keys)."""
    if state is None:
        return []
    host = state_to_numpy(state)
    return [{k: v[ch] for k, v in host.items()} for ch in range(nch)]


def _state_from_list(states: list[dict[str, np.ndarray]], device) -> dict | None:
    if not states:
        return None
    return state_from_numpy({k: np.stack([st[k] for st in states]) for k in states[0]}, device)


def _resume(checkpoint: str | None, meta: dict, output: str, device):
    """(checkpoint or None, frame offset per channel, stream state) to start
    from: the saved ones when the checkpoint was made for the same input and
    chunk size and the partial output is there, else a fresh start."""
    if not checkpoint:
        return None, 0, None
    ckpt = StreamCheckpoint(checkpoint)
    loaded = ckpt.load()
    if loaded is not None:
        offset, states, saved = loaded
        if all(saved.get(k) == v for k, v in meta.items()) and os.path.exists(output):
            return ckpt, offset, _state_from_list(states, device)
    return ckpt, 0, None


class _Lag:
    """Brings each chunk's result to the host one chunk late.

    On the card, `mark` records an event after a chunk's last kernel, and
    `fetch` copies that chunk on a side stream that waits only for the
    event, so the copy and the host's write of chunk k run while the card
    computes chunk k + 1.  On the CPU the result is already there."""

    def __init__(self, device: torch.device):
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.phases = {"read_s": 0.0, "dispatch_s": 0.0, "drain_fetch_s": 0.0, "write_s": 0.0,
                       "n_drains": 0, "drain_bytes": 0}

    def mark(self, result: torch.Tensor):
        if self._stream is None:
            return result, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(result.device))
        return result, event

    def fetch(self, marked) -> np.ndarray:
        result, event = marked
        t = time.perf_counter()
        if event is None:
            host = result.numpy()
        else:
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(event)
                host = result.to("cpu").numpy()
        self.phases["drain_fetch_s"] += time.perf_counter() - t
        self.phases["n_drains"] += 1
        self.phases["drain_bytes"] += host.nbytes
        return host


def _report(phases: dict, timings: dict | None) -> None:
    if timings is not None:
        timings.update({k: (round(v, 4) if isinstance(v, float) else v) for k, v in phases.items()})


def _run_chunks(chunks, dispatch, write, writer, state, ckpt, checkpoint_every: int, meta: dict,
                nch: int, total: int, on_progress, lag: _Lag) -> None:
    """The chunk loop of both file transcodes.  `chunks` yields (first
    frame, frame count, host chunk); `dispatch(chunk, state)` queues a chunk
    on the device and returns (result, new state); `write` takes a result on
    the host.  The lagging chunk is written, once, before every checkpoint
    and at the end; `on_progress` runs after a chunk is dispatched."""
    pending, done = None, 0
    try:
        for cs, n, host in chunks:
            t = time.perf_counter()
            result, state = dispatch(host, state)
            marked = lag.mark(result)
            lag.phases["dispatch_s"] += time.perf_counter() - t
            if pending is not None:
                write(lag.fetch(pending))
            pending = marked
            done += 1
            if ckpt is not None and done % checkpoint_every == 0:
                write(lag.fetch(pending))
                pending = None
                writer.flush()
                ckpt.save(cs + n, _state_to_list(state, nch), meta)
            if on_progress:
                on_progress(cs + n, total)
        if pending is not None:
            write(lag.fetch(pending))
    finally:
        writer.close()


def encode_file(
    input_wav: str,
    output_aea: str,
    options: EncoderOptions | None = None,
    engine: str = "tpu",
    title: str = "",
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    on_progress: Callable[[int, int], None] | None = None,
    checkpoint: str | None = None,
    checkpoint_every: int = 4,
    mesh=None,
    timings: dict | None = None,
    *,
    device=None,
    plain: bool = False,
) -> TranscodeResult:
    """Bounded-memory streaming encode: chunked WAV in, incremental AEA out
    (bin/cli.js:165-354), on the card unless `device="cpu"`, with `engine`
    "tpu" (the batched encoder) or "exact" (the reference's bytes).

    The chunks are `encode_pcm`'s (full chunks, then a short last one), so
    the units are byte-equal to `encode_pcm` of the file's samples with the
    same `chunk_frames`.  16-bit input is uploaded as raw int16 and converted
    on the device; 24- and 32-bit input as f32.  With `checkpoint`, the frame
    offset and the stream state are saved every `checkpoint_every` chunks
    with the input's path and `chunk_frames`, and a killed run given the same
    ones resumes there with byte-identical output.  `timings`, if given, is
    filled with the wall-clock split (read_s, dispatch_s, drain_fetch_s,
    write_s, n_drains, drain_bytes).

    `mesh` (a tuple of devices, see `parallel.sharding.make_mesh`) splits
    each chunk's frames across its devices.  The stream state is carried
    between chunks as without a mesh and handed to shard 0, so the
    checkpoint has the same keys, a mesh run resumes without one and the
    other way round, and the units equal those of a run without a mesh
    (bitwise whenever the f32 encoder gives the same bits on the shards'
    rows).  This departs from the JAX package, whose mesh runs carry and
    checkpoint the last two raw frames instead.  As in the JAX package, a
    mesh run is the batched engine's and does not consult `engine`."""
    _check_engine(engine)
    mesh, dev = _placement(mesh, device, plain)
    with WavStreamReader(input_wav) as reader:
        nch = reader.info.channels
        if nch not in (1, 2):
            raise ValueError(f"Unsupported channel count: {nch}")
        nframes = reader.num_frames
        options = options or EncoderOptions()
        meta = {"input": os.path.abspath(input_wav), "chunk_frames": chunk_frames}
        ckpt, start, state = _resume(checkpoint, meta, output_aea, dev)
        writer = AeaStreamWriter(output_aea, title=title, channel_count=nch,
                                 resume_at_frame=start * nch if start else None)
        lag = _Lag(dev)

        def chunks():
            for cs in range(start, nframes, chunk_frames):
                n = min(chunk_frames, nframes - cs)
                t = time.perf_counter()
                raw = reader.read_frames_i16(cs, n)
                if raw is None:
                    raw = reader.read_frames(cs, n)
                lag.phases["read_s"] += time.perf_counter() - t
                yield cs, n, torch.from_numpy(raw.reshape(nch, n, C.SAMPLES_PER_FRAME))

        def write(units: np.ndarray) -> None:                          # [C, n, 212]
            t = time.perf_counter()
            writer.append(units[0] if nch == 1 else aea.interleave_stereo(units[0], units[1]))
            lag.phases["write_s"] += time.perf_counter() - t

        if mesh is None:
            dispatch = lambda x, st: _encode_batch_dev(x.to(dev), options, st, plain=plain, engine=engine)  # noqa: E731
        else:
            dispatch = lambda x, st: _encode_chunk_sharded(x, options, st, mesh)  # noqa: E731
        _run_chunks(chunks(), dispatch, write, writer, state, ckpt, checkpoint_every, meta, nch, nframes, on_progress,
                    lag)
    _report(lag.phases, timings)
    if ckpt is not None:
        ckpt.remove()
    return TranscodeResult(frames=writer.frames_written, channels=nch, samples=reader.info.num_samples,
                           duration=reader.info.duration)


def decode_file(
    input_aea: str,
    output_wav: str,
    engine: str = "tpu",
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    on_progress: Callable[[int, int], None] | None = None,
    checkpoint: str | None = None,
    checkpoint_every: int = 4,
    mesh=None,
    timings: dict | None = None,
    *,
    device=None,
    plain: bool = False,
) -> TranscodeResult:
    """Bounded-memory streaming decode (the mirror of `encode_file`): each
    chunk's units are uploaded, decoded bit-exactly and converted to int16
    on the device, and written to a 16-bit WAV.  An odd stereo unit count
    gets a silent unit (processor.js:201-211).  `mesh` splits each chunk's
    frames across its devices, as in `encode_file`; the WAV is byte-equal
    to a run without one.  Both engines decode with the same bit-exact
    decoder; `engine` is checked and kept for the JAX package's signature."""
    _check_engine(engine)
    mesh, dev = _placement(mesh, device, plain)
    with AeaStreamReader(input_aea) as reader:
        nch = reader.meta.channel_count
        if nch not in (1, 2):
            raise ValueError(f"Unsupported channel count: {nch}")
        total_units = reader.num_units
        frames_per_ch = -(-total_units // nch)
        meta = {"input": os.path.abspath(input_aea), "chunk_frames": chunk_frames}
        ckpt, start, state = _resume(checkpoint, meta, output_wav, dev)
        writer = WavStreamWriter(output_wav, channels=nch,
                                 resume_at_samples=start * C.SAMPLES_PER_FRAME if start else None)
        lag = _Lag(dev)

        def chunks():
            for cs in range(start, frames_per_ch, chunk_frames):
                n = min(chunk_frames, frames_per_ch - cs)
                t = time.perf_counter()
                raw = reader.read_units(nch * cs, nch * n)
                if raw.shape[0] < nch * n:                             # the odd stereo tail
                    raw = np.concatenate([raw, C.SILENT_UNIT[None]])
                units = np.stack([raw] if nch == 1 else aea.deinterleave_stereo(raw))    # channel-major
                lag.phases["read_s"] += time.perf_counter() - t
                yield cs, n, torch.from_numpy(units)

        def write(pcm: np.ndarray) -> None:                            # int16 [C, n, 512]
            t = time.perf_counter()
            writer.append_i16(pcm.reshape(nch, -1))
            lag.phases["write_s"] += time.perf_counter() - t

        if mesh is None:
            dispatch = lambda x, st: _decode_batch_dev(x.to(dev), st, to_i16=True, plain=plain)  # noqa: E731
        else:
            dispatch = lambda x, st: _decode_chunk_sharded(x, st, mesh)  # noqa: E731
        _run_chunks(chunks(), dispatch, write, writer, state, ckpt, checkpoint_every, meta, nch, frames_per_ch,
                    on_progress, lag)
    _report(lag.phases, timings)
    if ckpt is not None:
        ckpt.remove()
    samples = frames_per_ch * C.SAMPLES_PER_FRAME
    return TranscodeResult(frames=total_units, channels=nch, samples=samples, duration=samples / C.SAMPLE_RATE)


def encode_clips(
    clips: list[np.ndarray],
    options: EncoderOptions | None = None,
    on_progress: Callable[[int, int], None] | None = None,
    device=None,
) -> list[np.ndarray]:
    """Encode many independent clips as one batch on the card.

    clips: f32 sample arrays, ragged: [N_i] mono or [channels, N_i] with 1
    or 2 channels.  Each clip is its own stream (fresh state, zero-padded
    tail frames).  Every channel of every clip becomes one row of a single
    [rows, F, 512] batch, right-padded to the longest clip; the padding
    frames are dropped per clip afterwards.  Returns one uint8 unit array
    per clip: [F_i, 212] mono, [2 F_i, 212] interleaved L,R stereo
    (processor.js:100-115)."""
    dev = resolve_device(device)
    options = options or EncoderOptions()
    chans: list[np.ndarray] = []                    # one row per channel
    row_of: list[tuple[int, ...]] = []              # per clip: its rows
    for clip in clips:
        clip = np.asarray(clip, np.float32)
        if clip.ndim == 1:
            clip = clip[None]
        if clip.ndim != 2 or clip.shape[0] not in (1, 2):
            raise ValueError(f"clip must be [N] or [1|2, N], got shape {clip.shape}")
        row_of.append(tuple(range(len(chans), len(chans) + clip.shape[0])))
        chans.extend(clip)
    frame_counts = [max(1, -(-c.shape[-1] // C.SAMPLES_PER_FRAME)) for c in chans]
    batch = np.zeros((len(chans), max(frame_counts), C.SAMPLES_PER_FRAME), np.float32)
    for i, ch in enumerate(chans):
        batch[i, : frame_counts[i]] = pcm_to_frames(ch)
    units, _ = _encode_batch_dev(torch.from_numpy(batch).to(dev), options, None)
    units = units.cpu().numpy()                     # [rows, F, 212]

    out = []
    for i, rows in enumerate(row_of):
        nf = frame_counts[rows[0]]
        if len(rows) == 1:
            out.append(units[rows[0], :nf])
        else:
            out.append(aea.interleave_stereo(units[rows[0], :nf], units[rows[1], :nf]))
        if on_progress:
            on_progress(i + 1, len(clips))
    return out
