"""Frame-axis data parallelism over a tuple of devices.

The port of `carta1_tpu/parallel/sharding.py`.  Every inter-frame
dependency of the codec is a window of the previous <= 2 raw frames:

  encoder state after frame k = G(raw[k-1], raw[k])          (QMF delay
    lines, transient spectra, MDCT band tails)
  decoder state after frame k = H(frameData[k-1], frameData[k])

so the frame axis splits into shards with no sequential chain: shard k
gets the last two frames of shard k-1 (its halo), rebuilds its boundary
state by running the ordinary step on them from the zero state, and then
runs its whole shard as one batch.  Shard 0 takes the caller's state (the
zero state by default).

A mesh is a tuple of devices, one per shard; a device may appear more
than once.  There is one process and no collective: shards that share a
device run as rows of one batch on the leading axis ([C*S, F/S, ...]),
their boundary states come from one batched 2-frame call, and each
device's work is queued on its own current stream before the results are
gathered on the mesh's first device.  With all shards on one device the
flattened rows are those of the unsharded batch, in the same order.

Decode is bit-exact by construction (the decoder and its kernels work row
by row), so a sharded decode equals the unsharded one and the gold
engine's bit for bit.  Encode is f32: within the JAX package's envelope of
the unsharded encode (`tests/test_sharding.py`), and usually equal.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.convert import framedata_from_numpy
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.ops.pcm import int16_to_float
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.pipeline.decoder import decode_frames, decode_step, decoder_init_state
from carta1_tpu_torch.pipeline.encoder import encode_frames, encode_step, encoder_init_state

HALO_FRAMES = 2

Mesh = tuple[torch.device, ...]


def make_mesh(devices=None) -> Mesh:
    """A tuple of devices, one per shard.  `None` means every visible CUDA
    device and raises if there is none; entries may repeat, e.g.
    ("cuda:0", "cuda:0") or ("cpu",) * 4."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass a mesh of CPU devices, e.g. ('cpu',) * 2")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            index = torch.cuda.current_device() if dev.index is None else dev.index
            if index >= torch.cuda.device_count():
                raise ValueError(f"make_mesh: {dev} is not among the {torch.cuda.device_count()} visible cards")
            dev = torch.device("cuda", index)
        mesh.append(dev)
    if not mesh:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return tuple(mesh)


def _pad_frames(n: int, shards: int) -> int:
    per = -(-n // shards)
    per = max(per, HALO_FRAMES)  # each shard must own >= halo frames
    return per * shards


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """x on dev, queued without a host wait where the copy lands on a card;
    a copy to the CPU waits, since the CPU reads it at once."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def _shard_map(inputs: tuple, step: Callable, init_state: Callable, state: dict, mesh: Mesh):
    """Run `step` over the frame axis of `inputs` split into len(mesh) shards.

    inputs: tensors [C, S * per, ...]; step(inputs [rows, n, ...], state) ->
    (outputs tuple [rows, n, ...], state); init_state(device, rows) -> the
    zero state; state: the state before frame 0, [C, ...] per key.
    Returns (outputs [C, S * per, ...] on mesh[0], the state after the last
    frame on mesh[0])."""
    s = len(mesh)
    c, total = inputs[0].shape[:2]
    per = total // s
    split = [x.reshape(c, s, per, *x.shape[2:]) for x in inputs]
    groups: dict[torch.device, list[int]] = {}
    for k, dev in enumerate(mesh):
        groups.setdefault(dev, []).append(k)

    results = []
    for dev, ks in groups.items():                  # queue every device's work before waiting on any
        whole = ks == list(range(s))
        rows = [_to((x if whole else x[:, ks]).reshape(c * len(ks), per, *x.shape[3:]), dev) for x in split]
        later = [k for k in ks if k > 0]
        if later:
            halo = [_to(x[:, [k - 1 for k in later], per - HALO_FRAMES:]
                        .reshape(c * len(later), HALO_FRAMES, *x.shape[3:]), dev) for x in split]
            _, boundary = step(halo, init_state(dev, c * len(later)))
        first = {key: _to(v, dev) for key, v in state.items()}
        row_state = {}
        for key, v in first.items():
            parts = [v if k == 0 else boundary[key].reshape(c, len(later), -1)[:, later.index(k)] for k in ks]
            row_state[key] = torch.stack(parts, dim=1).reshape(c * len(ks), -1)
        outs, new_state = step(rows, row_state)
        results.append((ks, outs, new_state))

    home = mesh[0]
    outputs = []
    for i in range(len(results[0][1])):
        if len(results) == 1:
            outputs.append(results[0][1][i].reshape(c, total, *results[0][1][i].shape[2:]))
            continue
        tail = results[0][1][i].shape[2:]
        out = torch.empty((c, s, per, *tail), dtype=results[0][1][i].dtype, device=home)
        for ks, outs, _ in results:
            out[:, ks] = outs[i].reshape(c, len(ks), per, *tail).to(home)
        outputs.append(out.reshape(c, total, *tail))
    ks, _, last = next(r for r in results if s - 1 in r[0])
    final = {key: v.reshape(c, len(ks), -1)[:, ks.index(s - 1)].to(home) for key, v in last.items()}
    return tuple(outputs), final


def _sharded(inputs: tuple, step: Callable, init_state: Callable, state: dict | None, mesh: Mesh):
    """Pad the frame axis of inputs [C, F, ...] for the mesh, run the shards,
    trim.  Returns (outputs [C, F, ...] on mesh[0], the state after frame
    F - 1 on mesh[0])."""
    c, nframes = inputs[0].shape[:2]
    home = mesh[0]
    if state is None:
        state = init_state(home, c)
    state = {k: v.reshape(c, -1) for k, v in state.items()}
    total = _pad_frames(nframes, len(mesh))
    padded = inputs if total == nframes else tuple(
        torch.cat([x, x.new_zeros((c, total - nframes, *x.shape[2:]))], dim=1) for x in inputs)
    outputs, final = _shard_map(padded, step, init_state, state, mesh)
    if total != nframes:
        # the state after the last real frame, not after the silent padding:
        # its last two frames from the zero state (the boundary rebuild), or
        # its only frame from the caller's state
        if nframes >= HALO_FRAMES:
            tail = tuple(x[:, nframes - HALO_FRAMES:nframes].to(home) for x in inputs)
            _, final = step(tail, init_state(home, c))
        else:
            _, final = step(tuple(x.to(home) for x in inputs), {k: v.to(home) for k, v in state.items()})
        outputs = tuple(x[:, :nframes] for x in outputs)
    return outputs, final


def encode_frames_sharded(pcm, options: EncoderOptions | None = None, mesh=None,
                          state: dict | None = None) -> tuple[FrameData, dict]:
    """pcm [F, 512] or [C, F, 512] (f32, or raw int16 samples converted on
    each device) -> (FrameData, state after frame F - 1), the frames split across the mesh
    (default: every visible card), the result on the mesh's first device.

    A leading channel axis batches channels; `state` (default: zero) is the
    stream state before frame 0, given to shard 0.  The tail is padded with
    silence to a multiple of the shard count (at least two frames a shard)
    and trimmed.  Unlike the JAX function, which returns the FrameData
    alone, this one returns the state too, so that chunks can carry it."""
    options = options or EncoderOptions()
    mesh = make_mesh(mesh)
    if not isinstance(pcm, torch.Tensor):
        pcm = torch.from_numpy(np.ascontiguousarray(pcm))
    if pcm.dtype != torch.int16:
        pcm = pcm.to(torch.float32)
    if pcm.dim() not in (2, 3) or pcm.shape[-1] != C.SAMPLES_PER_FRAME:
        raise ValueError(f"encode_frames_sharded: need PCM [F, 512] or [C, F, 512], got {tuple(pcm.shape)}")
    mono = pcm.dim() == 2
    if pcm.shape[-2] == 0:
        pcm = int16_to_float(pcm) if pcm.dtype == torch.int16 else pcm
        return encode_frames(pcm, options, state, device=mesh[0])
    x = pcm[None] if mono else pcm

    def step(inputs, st):
        frames = inputs[0]
        frames = int16_to_float(frames) if frames.dtype == torch.int16 else frames
        fd, st = encode_step(frames, st, options.band_thresholds, options.allocation_bias, options.allocator)
        return tuple(getattr(fd, k) for k in FrameData.fields()), st

    fields, final = _sharded((x,), step, lambda dev, rows: encoder_init_state(dev, rows), state, mesh)
    fd = FrameData(*fields)
    if mono:
        return fd[0], {k: v[0] for k, v in final.items()}
    return fd, final


def decode_frames_sharded(fd, mesh=None, state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """FrameData [F, ...] or [C, F, ...] (torch, or any object with the five
    fields as arrays) -> (pcm [F, 512] or [C, F, 512] f32, state after frame
    F - 1), the frames
    split across the mesh (default: every visible card), the result on the
    mesh's first device; bit-identical to the unsharded decode.

    A leading channel axis batches channels; `state` (default: zero) is the
    stream state before frame 0, given to shard 0.  Padding frames are
    silent (n_bfu = 0) and trimmed."""
    mesh = make_mesh(mesh)
    if not isinstance(fd, FrameData):
        fd = framedata_from_numpy(fd, "cpu")
    if fd.n_bfu.dim() not in (1, 2):
        raise ValueError(f"decode_frames_sharded: need FrameData [F, ...] or [C, F, ...], got n_bfu {tuple(fd.n_bfu.shape)}")
    mono = fd.n_bfu.dim() == 1
    if fd.num_frames == 0:
        return decode_frames(fd, state, device=mesh[0])
    fields = tuple(getattr(fd, k)[None] if mono else getattr(fd, k) for k in FrameData.fields())

    def step(inputs, st):
        pcm, st = decode_step(FrameData(*inputs), st)
        return (pcm,), st

    (pcm,), final = _sharded(fields, step, lambda dev, rows: decoder_init_state(dev, rows), state, mesh)
    if mono:
        return pcm[0], {k: v[0] for k, v in final.items()}
    return pcm, final
