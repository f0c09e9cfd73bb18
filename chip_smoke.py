#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port builds, encodes and decodes on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  python3 chip_smoke.py [--record PATH]

Phases (each raises on failure; nothing is caught):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: compiles every kernel (K1 IMDCT at sizes 64/256/512, K2 QMF
     taps, K3 field read, K4 the two bit allocators, K5 the reference's
     heap allocator, K6 the fft.js forward MDCT and magnitude spectrum)
     and the rate probe from carta1_tpu_torch/csrc, all nvcc runs at once;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the first stereo 8192-frame chunk of the transcode gives it,
     and on edge inputs (batches around a block's tile, small widths, +0,
     -0, denormals, overflow to inf, lone samples at a row's ends; for K4
     NaN and inf coefficients, silent and all-63 frames, exact ties across
     BFUs, plateaus of the hull, each at biases 0.7, 1.0 and 2.0): 0
     differing words allowed; kernel, plain and library-call times, the
     time of an empty launch, and the kernel's bound: the largest of its
     bytes at the memory rate, its arithmetic at the data sheet's rate and,
     for K1 and K6, its f32 <-> f64 conversions at the rate the round-trip
     loop of csrc/probe_rates.cu measures in this run;
  4. the golden fixture decoded to int16 on the card equals
     tests/fixtures/golden_decode.npz exactly;
  5. the encoder on the card against tests/fixtures/torch_encode_expect.npz
     (the gold engine on six signal classes): block modes and scale
     factors equal gold's with the reference allocator, round-trip PSNR at
     least gold's with the default one, the bit budget on every frame, the
     share of fields equal to the CPU run, and what an f32 log2 would make
     of amplitudes around every scale-factor table value; launch counters
     reset before and read after: the path of K4's reference allocator;
  6. the main path: a stereo int16 stream of 4 x 8192 frames per channel,
     chunk by chunk through encode -> 212-byte units on the card -> decode
     -> int16, both stream states carried; launch counters reset just
     before and read just after; units and int16 must equal the same run
     with the plain versions and a second run, every kernel of the path
     (all but K4's reference allocator) must have launched; then
     encode_pcm -> decode_units on a prefix, and the times
     of the transcode, of encode alone and of decode alone;
  7. the decode stream of golden units (2 x 8192 stereo frames through
     decode_units) against the plain path, and 64 units of random bytes;
  8. torch.profiler over one chunk's encode and one chunk's decode: device
     time by operation, launches, the hand kernels' device time;
  9. the file layer: phase 6's stream as a WAV through encode_file and
     decode_file (units and int16 equal to phase 6's; launch counters reset
     just before and read just after, every kernel of phase 6's path must
     have launched), a killed and resumed encode and decode
     (byte-identical), the CLI's
     --encode/--decode (byte-identical) and --json (equal to the CPU's dump),
     encode_clips against encode_pcm per clip (at most 1% of bytes differ),
     and the file walls (a first run and three repeats) and their split
     beside phase 6's in-memory walls;
 10. the last entry points, on a mesh of two shards on cuda:0 (and on every
     card when there are more than one): (a) phase 6's stream through
     encode_frames_sharded -> pack -> unpack -> decode_frames_sharded, chunk
     by chunk with both states carried (units equal to phase 6's or inside
     the JAX package's sharded-encode envelope, int16 equal to phase 6's;
     launch counters reset just before and read just after, every kernel of
     phase 6's path must have launched); (b) encode_file / decode_file with
     the mesh, bytes equal to phase 9's files, killed and resumed with and
     without the mesh; (c) the fast decoder within one int16 step of the
     golden fixture (fewer than 1% of samples off) and of phase 6's exact
     int16; (d) encode_stream / decode_stream equal to encode_pcm /
     decode_units; (e) transcode_corpus over 8 stereo WAVs of 4096 frames
     and a broken file (outputs equal to each file alone, the broken one
     failed with no output, a resumed run skips the 8) and two gloo
     processes of `python -m carta1_tpu_torch.parallel.multihost` on cuda:0
     (disjoint, complete); walls and the corpus's realtime multiple.
     Phases 9, 10 and 13 write under build/ and delete it after 13;
 11. the exact engine (engine="exact"): (a) the golden signal's stored
     input through encode_pcm on the card, units byte-equal to
     tests/fixtures/golden.aea, decoded to int16 equal to golden_decode.npz;
     (b) the six signal classes and the bias variants of
     tests/fixtures/torch_exact_expect.npz byte-equal to the gold engine's
     units, mono and as stereo pairs, 3-frame chunks equal to one chunk;
     (c) phase 6's stream through the exact encode -> units -> exact decode
     -> int16, both states carried, launch counters reset just before and
     read just after (K5 and K6 must have launched), units and int16 equal
     to the plain path and to a second run; ms per chunk, device busy under
     the profiler, the share of fields equal to phase 6's batched engine,
     the smallest margin of a transient score to its threshold; (d) K5 and
     K6 against their plain versions in phase 3's manner, at (c)'s first
     chunk's shapes and on edge inputs (K6's short MDCT masked by that
     chunk's modes, and under all-off, all-on, alternating and
     first-and-last masks; also every row transformed), with K5's serial
     chain per frame counted by its plain version: accepted steps, pops,
     compared sift levels, and the mean over warps of a warp's longest;
 12. the gold surface (gold/transforms.py, gold/coding.py with the JAX
     package's signatures) on the card at the shapes of (c)'s first chunk:
     mdct_js / mdct on K6 and imdct_js / imdct on K1 at the instance
     scales and at gold's default scales, qmf_synthesis_stream on K2 over
     the chunk's bands (and in three calls with the delay carried, equal to
     one call), allocate_bits / allocate_bits_frame on K5 and
     allocate_bits_sweep on K4's alloc_reference, each against its plain
     route with 0 differing words, launch counters reset just before and
     read just after (K1, K2, K4's alloc_reference, K5 and K6 must have
     launched); overlap_add_js, find_scale_factors and dequantize_js on the
     card against the CPU; K1 and K6 timed at a non-instance scale; then
     encode_pcm / decode_units with on_progress on phase 6's prefix (the
     calls listed, units and int16 equal to phase 6's); the phase's walls;
 13. the JAX package's calling contract on the card: the positional calls a
     user of carta1_tpu writes (encode_file(wav, aea, None, "exact"),
     decode_file(aea, wav, "exact"), encode_pcm(pcm, options, "exact"),
     decode_units(units, 2, "exact"), the same with "tpu" and chunk_frames,
     decode_frames(fd, None, True)) against the keyword calls and against
     phases 6 and 9 (phase 9's files, phase 6's prefix), byte for byte;
     launch counters reset just before and read just after (every kernel
     but K4's reference allocator must have launched);
 14. the path of K4's reference allocator at full width: phase 6's stream
     through the transcode with EncoderOptions(allocator="reference"),
     both states carried; launch counters reset just before and read just
     after (alloc_reference once per chunk, alloc_rdo never, every other
     kernel of phase 6's path); word lengths, units and int16 of every chunk
     equal to the same chunks through plain=True on the card; ms per chunk
     (median repeat) and one chunk's encode under the profiler, each in
     turns with phase 6's allocator; the CLI's --allocator reference on the
     stream's first 256 frames as a WAV, units byte-equal to encode_pcm
     with the same options;
 15. the measurement harness (carta1_tpu_torch.harness) on the card, each
     module once: bench at its defaults (its first chunk's units and int16
     equal to encode_pcm -> decode_units of that chunk), profile_stages at
     its defaults, quality_report at its defaults (the worst delta_db at
     least 0: the encode contract), bench_scaling over the cards present
     and ("cuda:0", "cuda:0"), and stream_stress in a process of its own at
     a reduced --minutes (the cut stated in its line); launch counters
     reset just before and read just after (every kernel but K4's
     reference allocator must have launched); every harness JSON line goes
     into the record.

The last lines are a JSON `kernels` line, the card's name and power limit,
and the result line.  The full record (every timing, the profile) goes to
--record, by default build/chip_smoke.json.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from carta1_tpu_torch.harness.common import profile as _profile
from carta1_tpu_torch.harness.common import smi as _smi
from carta1_tpu_torch.harness.common import sync as _sync
from carta1_tpu_torch.harness.common import timed as _timed

CHUNK = 8192
CHUNKS = 4
DECODE_CHUNKS = 2          # the decode-only stream of golden units
# NVIDIA H100 SXM data sheet peaks (dense, 700 W): HBM3 bytes/s, and FP64
# and FP32 outside the tensor cores.  The sheet's 34 and 67 TFLOP/s count an
# FMA as two operations; the exact kernels may not fuse a multiply with an
# add, so the rates they can reach are half of them.
PEAK_BYTES_S = 3.35e12
PEAK_F64_S = 17e12
PEAK_F32_S = 33.5e12
# which path's launch counts hold each kernel: K4's reference allocator runs
# in phase 14 (allocator="reference"), the exact engine's K5 and K6 in phase
# 11 (engine="exact"), every other kernel on the main path (phase 6)
EXACT_KERNELS = ("alloc_heap", "fft_js_mdct_64", "fft_js_mdct_256", "fft_js_mdct_512", "fft_js_spectrum_128",
                 "fft_js_spectrum_256")
PATHS = {"alloc_reference": "phase 14", **{k: "phase 11" for k in EXACT_KERNELS}}
STRESS_MINUTES = 10        # phase 15's stream_stress, cut from its 60 to keep the phase near 90 s


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """(differing 32-bit words, treating +0 == -0; max |a - b|)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.dtype == torch.float32:
        same = (a.view(torch.int32) == b.view(torch.int32)) | ((a == 0) & (b == 0))
        err = (a.double() - b.double()).abs().nan_to_num(float("inf"))
    else:
        same = a == b
        err = (a.long() - b.long()).abs().double()
    return int((~same).sum()), float(err.max()) if err.numel() else 0.0


def _bound_ms(nbytes: float, ops: float, rate: float = PEAK_F64_S, conversions: float = 0.0,
              conv_rate: float = float("inf")) -> tuple[float, str, str]:
    """The least time for the bytes at the memory rate, the operations at
    `rate` and the f32 <-> f64 conversions at `conv_rate` (conversions per
    second, measured in this run): (ms, "bytes" or "operations", which
    term: "bytes", "arithmetic" or "conversions")."""
    terms = {"bytes": nbytes / PEAK_BYTES_S * 1e3, "arithmetic": ops / rate * 1e3,
             "conversions": conversions / conv_rate * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def _imdct_conversions(rows: int, n: int) -> int:
    """K1's f32 <-> f64 conversions for rows of an n-point IMDCT core: the
    pre-twiddle widens 2 samples and rounds 2 values per point, each of the
    log2(n) stages widens and rounds the 2n values of a row (4n), the
    post-twiddle widens 2 and rounds 2 per point."""
    return rows * (8 * n + 4 * n * (n.bit_length() - 1))


def _fftjs_conversions(kind: str, rows: int, n: int) -> int:
    """K6's conversions for rows of an n-point transform: 4n per stage; the
    MDCT's pre-twiddle widens 4 samples and rounds 2 values per point and
    its post-twiddle widens 2 and rounds 2; the magnitude widens 2 and
    rounds 1 per bin of n/2."""
    stages = 4 * n * (n.bit_length() - 1)
    return rows * (stages + (10 * n if kind == "mdct" else 3 * n // 2))


def _digest(units: torch.Tensor, pcm: torch.Tensor) -> dict:
    """SHA-256 of phase 6's units and int16 samples, as bytes on the host."""
    import hashlib

    return {k: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for k, t in (("units", units), ("int16", pcm))}


def phase6_digest() -> dict:
    """Phase 6's transcode alone (the same stream, chunks and options), run
    with whichever `carta1_tpu_torch` is first on sys.path, and its digest:
    the way to hold another tree's main path against this one's."""
    from carta1_tpu_torch import EncoderOptions, testing
    from carta1_tpu_torch.ops.pcm import float_to_int16
    from carta1_tpu_torch.processor import _decode_batch_dev, _encode_batch_dev

    dev = torch.device("cuda")
    source = testing.synth_audio(CHUNK * CHUNKS, 2)
    pcm16 = float_to_int16(torch.from_numpy(source)).numpy().reshape(2, CHUNK * CHUNKS, 512)
    est = dst = None
    units_out, pcm_out = [], []
    for k in range(CHUNKS):
        x = torch.from_numpy(np.ascontiguousarray(pcm16[:, k * CHUNK:(k + 1) * CHUNK])).to(dev)
        units, est = _encode_batch_dev(x, EncoderOptions(), est)
        pcm, dst = _decode_batch_dev(units, dst, to_i16=True)
        units_out.append(units)
        pcm_out.append(pcm)
    return _digest(torch.cat(units_out, dim=1), torch.cat(pcm_out, dim=1))


def _spectra(rng: np.random.Generator, rows: int, cols: int, dev) -> torch.Tensor:
    x = rng.standard_normal((rows, cols)) * np.exp2(rng.integers(-10, 4, (rows, cols)))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _stereo_stream(units: np.ndarray) -> np.ndarray:
    """2 x 8192 frames per channel, tiled from the golden units with
    different offsets for L and R (both keep the fixture's short frames)."""
    n = CHUNK * DECODE_CHUNKS
    reps = -(-(n + 41) // units.shape[0])
    tiled = np.tile(units, (reps, 1))
    left, right = tiled[:n], tiled[41:41 + n]
    out = np.empty((2 * n, units.shape[1]), np.uint8)
    out[0::2], out[1::2] = left, right
    return out


class _KillAfter:
    """Progress callback that raises on its n-th call (a killed run)."""

    def __init__(self, n: int):
        self.n, self.calls = n, 0

    def __call__(self, done: int, total: int) -> None:
        self.calls += 1
        if self.calls >= self.n:
            raise KeyboardInterrupt("simulated kill")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def files_phase(pcm16: np.ndarray, units: torch.Tensor, pcm: torch.Tensor, options, smi: str, walls: dict,
                golden_aea: str) -> dict:
    """Phase 9: phase 6's stream ([2, F, 512] int16; its units and int16
    output on the card) through the file entry points, the CLI and
    encode_clips on the card."""
    from carta1_tpu_torch import cli, decode_file, encode_clips, encode_file, encode_pcm, kernels, testing
    from carta1_tpu_torch.io.aea import read_aea
    from carta1_tpu_torch.io.wav import write_wav

    work = os.path.join("build", "chip_smoke_files")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = {k: os.path.join(work, k) for k in ("in.wav", "out.aea", "out.wav", "resumed.aea", "resumed.wav",
                                               "cli.aea", "cli.wav", "card.json", "cpu.json", "ck.npz")}
    nch, nframes = pcm16.shape[0], pcm16.shape[1]
    write_wav(path["in.wav"], pcm16.reshape(nch, -1))
    wav_size = os.path.getsize(path["in.wav"])

    # 9a. encode_file and decode_file, against phase 6's units and int16
    timings = {"encode": {}, "decode": {}}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    encode_file(path["in.wav"], path["out.aea"], options, title="smoke", chunk_frames=CHUNK, timings=timings["encode"])
    enc_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode_file(path["out.aea"], path["out.wav"], chunk_frames=CHUNK, timings=timings["decode"])
    dec_wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0 and k not in PATHS]
    if missing:
        raise AssertionError(f"files: encode_file -> decode_file launched no {missing}: {launches}")
    meta, got_units = read_aea(path["out.aea"])
    want = units.cpu().numpy()
    if (meta.frame_count, meta.channel_count) != (nch * nframes, nch) or got_units.shape != (nch * nframes, 212):
        raise AssertionError(f"files: AEA header {meta}, units {got_units.shape}")
    if not (np.array_equal(got_units[0::2], want[0]) and np.array_equal(got_units[1::2], want[1])):
        raise AssertionError("files: encode_file's units differ from phase 6's")
    wav_bytes = _read(path["out.wav"])
    samples = np.frombuffer(wav_bytes[44:], "<i2").reshape(-1, nch).T
    if not np.array_equal(samples, pcm.cpu().numpy().reshape(nch, -1)):
        raise AssertionError("files: decode_file's int16 samples differ from phase 6's")
    aea_bytes = _read(path["out.aea"])

    # 9b. killed after the second chunk, then resumed: byte-identical
    for run, src, out, ref in ((encode_file, path["in.wav"], path["resumed.aea"], aea_bytes),
                               (decode_file, path["out.aea"], path["resumed.wav"], wav_bytes)):
        kw = dict(chunk_frames=CHUNK, checkpoint=path["ck.npz"], checkpoint_every=1)
        if run is encode_file:
            kw.update(options=options, title="smoke")
        try:
            run(src, out, on_progress=_KillAfter(2), **kw)
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("files: the simulated kill did not happen")
        if not os.path.exists(path["ck.npz"]):
            raise AssertionError("files: no checkpoint after the kill")
        run(src, out, **kw)
        if os.path.exists(path["ck.npz"]) or _read(out) != ref:
            raise AssertionError(f"files: resumed {run.__name__} is not byte-identical to the full run")

    # 9c. the CLI on the card, and --json on the card against the CPU
    for argv, out, ref in ((["--encode", path["in.wav"], path["cli.aea"], "--title", "smoke"], path["cli.aea"], aea_bytes),
                           (["--decode", path["out.aea"], path["cli.wav"]], path["cli.wav"], wav_bytes)):
        if cli.main(argv + ["--quiet"]) != 0 or _read(out) != ref:
            raise AssertionError(f"files: cli {argv[0]} is not byte-identical to the entry point's file")
    if (cli.main(["--json", golden_aea, path["card.json"], "--quiet"]) != 0
            or cli.main(["--json", golden_aea, path["cpu.json"], "--quiet", "--device", "cpu"]) != 0):
        raise AssertionError("files: cli --json failed")
    if json.loads(_read(path["card.json"])) != json.loads(_read(path["cpu.json"])):
        raise AssertionError("files: cli --json on the card differs from the CPU's dump")

    # 9d. encode_clips: five ragged clips, mono and stereo, against each alone
    src = testing.synth_audio(700, 2)
    clips = [src[0, : 100 * 512 + 17], src[:, 5000: 5000 + 300 * 512], src[1, : 37], src[:, : 511],
             src[0, 9000: 9000 + 699 * 512 + 300]]
    batched = encode_clips(clips, options)
    diff = []
    for clip, got in zip(clips, batched):
        solo = encode_pcm(np.atleast_2d(clip), options)
        if got.shape != solo.shape:
            raise AssertionError(f"encode_clips: {got.shape} units against {solo.shape} alone")
        diff.append(float((got != solo).mean()))
    if max(diff) > 0.01:
        raise AssertionError(f"encode_clips: shares of differing bytes {diff} exceed 1%")

    # 9e. times: three more runs of each, their median and split beside the first
    repeats = {"encode": [], "decode": []}
    for _ in range(3):
        for part, run, src, out in (("encode", encode_file, path["in.wav"], path["resumed.aea"]),
                                    ("decode", decode_file, path["out.aea"], path["resumed.wav"])):
            split = {}
            t0 = time.perf_counter()
            run(src, out, chunk_frames=CHUNK, timings=split)
            repeats[part].append((time.perf_counter() - t0, split))
    cf = nch * nframes
    med = {part: sorted(r, key=lambda x: x[0])[1] for part, r in repeats.items()}
    print(f"files: encode_file of {nframes} x {nch} frames (a {wav_size}-byte WAV) {enc_wall:.4f} s first, repeats "
          f"{', '.join(f'{w:.4f}' for w, _ in repeats['encode'])} s = {cf / med['encode'][0]:.1f} channel-frames/s "
          f"(median); decode_file {dec_wall:.4f} s first, repeats {', '.join(f'{w:.4f}' for w, _ in repeats['decode'])} "
          f"s = {cf / med['decode'][0]:.1f} channel-frames/s; in memory (phase 6, median repeat): encode "
          f"{walls['encode']:.4f} s, decode {walls['decode']:.4f} s; on {smi}")
    for part in ("encode", "decode"):
        print(f"files: {part}_file split, first run {timings[part]}; median repeat {med[part][1]}")
    print(f"files: units and int16 equal to phase 6's; kill + resume byte-identical for both; CLI --encode/--decode "
          f"byte-identical, --json equal to the CPU's; encode_clips differing bytes per clip {diff}; launches {launches}")
    return {"encode_file_seconds": enc_wall, "decode_file_seconds": dec_wall,
            "repeat_seconds": {p: [w for w, _ in r] for p, r in repeats.items()},
            "encode_file_channel_frames_per_s": cf / med["encode"][0],
            "decode_file_channel_frames_per_s": cf / med["decode"][0],
            "in_memory_seconds": {"encode": walls["encode"], "decode": walls["decode"]},
            "timings": timings, "repeat_timings": {p: [t for _, t in r] for p, r in repeats.items()},
            "launches": launches, "encode_clips_differing_bytes": diff, "card": smi}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _field_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Units uint8 [..., 212] against units: the JAX package's sharded-encode
    envelope (tests/test_sharding.py) on their fields: block modes and scale
    factors equal, quantized values at most 1 apart in fewer than 1e-3."""
    from carta1_tpu_torch.ops.bitpack import unpack_frames

    a, b = unpack_frames(got.reshape(-1, 212)), unpack_frames(want.reshape(-1, 212))
    q = (a.quantized.long() - b.quantized.long()).abs()
    out = {"unit_bytes_differing": int((got != want).sum()),
           "fields_differing": {k: int((getattr(a, k) != getattr(b, k)).sum()) for k in a.fields()},
           "quantized_max_diff": int(q.max()), "quantized_share_differing": float((q != 0).double().mean())}
    if (out["fields_differing"]["block_modes"] or out["fields_differing"]["scale_factors"]
            or out["quantized_max_diff"] > 1 or out["quantized_share_differing"] >= 1e-3):
        raise AssertionError(f"sharded encode outside the JAX package's envelope: {out}")
    return out


def sharded_phase(pcm16: np.ndarray, units: torch.Tensor, pcm: torch.Tensor, options, walls: dict, work: str,
                  golden_units: np.ndarray, golden: np.ndarray, dev: torch.device, chunk: int = CHUNK) -> dict:
    """Phase 10: phase 6's stream ([2, F, 512] int16; its units and int16 on
    `dev`) through the sharded, corpus, fast-decode and stream entry points,
    on a mesh of two shards on `dev` (and, for the sharded transcode, on a
    mesh of `dev` and the CPU); phase 9's files in `work`."""
    from carta1_tpu_torch import constants as C
    from carta1_tpu_torch import (decode_file, decode_frames, decode_frames_sharded, decode_units, encode_file,
                                  encode_frames_sharded, encode_pcm, encoder_init_state, kernels, make_mesh, testing,
                                  transcode_corpus)
    from carta1_tpu_torch.io.aea import interleave_stereo
    from carta1_tpu_torch.io.wav import write_wav
    from carta1_tpu_torch.ops.bitpack import pack_frames, unpack_frames
    from carta1_tpu_torch.ops.pcm import float_to_int16, int16_to_float
    from carta1_tpu_torch.pipeline.encoder import analysis_step
    from carta1_tpu_torch.pipeline.streaming import chunk_frames_array, decode_stream, encode_stream

    nch, nframes = pcm16.shape[:2]
    chunks = nframes // chunk
    rec: dict = {}

    def upload(k: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(pcm16[:, k * chunk:(k + 1) * chunk])).to(dev)

    # 10a. the sharded transcode, chunk by chunk, both states carried
    def transcode(mesh, n: int = chunks):
        est = dst = None
        units_out, pcm_out = [], []
        for k in range(n):
            fd, est = encode_frames_sharded(upload(k), options, mesh, est)
            u = pack_frames(fd)
            out, dst = decode_frames_sharded(unpack_frames(u), mesh, dst)
            units_out.append(u)
            pcm_out.append(float_to_int16(out))
        return torch.cat(units_out, dim=1), torch.cat(pcm_out, dim=1)

    meshes = {"two shards on one card": make_mesh((dev, dev))}
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        meshes["every card"] = make_mesh()
    rec["sharded"] = {}
    for label, mesh in meshes.items():
        transcode(mesh, 1)                                                 # warm
        _sync(dev)
        kernels.reset_launches()
        wall, (s_units, s_pcm) = _timed(lambda: transcode(mesh), dev)
        launches = dict(kernels.LAUNCHES)
        missing = [k for k, v in launches.items() if v == 0 and k not in PATHS]
        if dev.type == "cuda" and missing:
            raise AssertionError(f"sharded transcode ({label}) launched no {missing}: {launches}")
        diff = _field_diff(s_units, units)
        if diff["unit_bytes_differing"] == 0:
            if _mismatch(s_pcm, pcm)[0]:
                raise AssertionError(f"sharded transcode ({label}): int16 differs from phase 6's on equal units")
        else:                                                              # decode phase 6's own units
            dst, outs = None, []
            for k in range(chunks):
                out, dst = decode_frames_sharded(unpack_frames(units[:, k * chunk:(k + 1) * chunk]), mesh, dst)
                outs.append(float_to_int16(out))
            if _mismatch(torch.cat(outs, dim=1), pcm)[0]:
                raise AssertionError(f"sharded decode ({label}): int16 differs from phase 6's")
        repeats = [_timed(lambda: transcode(mesh), dev)[0] for _ in range(3)]
        per_chunk = sorted(repeats)[1] / chunks * 1e3
        prof = _profile(lambda: transcode(mesh, 1))
        rec["sharded"][label] = {"mesh": [str(d) for d in mesh], "seconds": wall, "repeat_seconds": repeats,
                                 "ms_per_chunk": per_chunk, "launches": launches, "profile_one_chunk": prof, **diff}
        print(f"sharded transcode ({label}, mesh {[str(d) for d in mesh]}): {chunks} x {chunk} stereo frames in "
              f"{wall:.4f} s, repeats {', '.join(f'{r:.4f}' for r in repeats)} s = {per_chunk:.3f} ms per chunk "
              f"(phase 6: {walls['transcode'] / chunks * 1e3:.3f}); one chunk under the profiler: device busy "
              f"{prof['device_ms']} ms in {prof['device_launches']} launches; units against phase 6's: "
              f"{diff['unit_bytes_differing']} bytes and {diff['fields_differing']} fields differ; int16 equal to "
              f"phase 6's; launches {launches}")
    if len(meshes) == 1:
        print("sharded transcode: one card visible, so no mesh over every card")

    # the path of a mesh over several devices (halos and results copied
    # between devices, shards gathered out of order) on a one-card host:
    # shards 0 and 2 on the card, shard 1 on the CPU with the plain
    # versions; two chunks (8192 frames on 3 shards: padded, so ragged),
    # both states carried, once
    mixed = make_mesh((dev, "cpu", dev))
    n_mixed = 2
    _sync(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    est, m_units = None, []
    for k in range(n_mixed):
        fd, est = encode_frames_sharded(upload(k), options, mixed, est)
        m_units.append(pack_frames(fd))
    dst, m_pcm = None, []
    for k in range(n_mixed):
        out, dst = decode_frames_sharded(unpack_frames(units[:, k * chunk:(k + 1) * chunk]), mixed, dst)
        m_pcm.append(float_to_int16(out))
    _sync(dev)
    m_wall = time.perf_counter() - t0
    m_launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in m_launches.items() if v == 0 and k not in PATHS]
    if missing:
        raise AssertionError(f"sharded transcode (card and CPU) launched no {missing}: {m_launches}")
    if _mismatch(torch.cat(m_pcm, dim=1), pcm[:, :n_mixed * chunk])[0]:
        raise AssertionError("sharded decode (card and CPU): int16 differs from phase 6's")
    ast, peaks = encoder_init_state(dev, nch), []
    mask = torch.from_numpy(C.BFU_SLOT_MASK).to(dev)
    for k in range(n_mixed):
        bfu, _, _, ast = analysis_step(int16_to_float(upload(k)), ast, options.band_thresholds)
        peaks.append(torch.where(mask, bfu.abs(), 0.0).amax(dim=-1))
    fields = [unpack_frames(u.reshape(-1, 212)) for u in (torch.cat(m_units, dim=1), units[:, :n_mixed * chunk])]
    agree = testing.backend_agreement(*({k: getattr(f, k).cpu().numpy() for k in f.fields()} for f in fields),
                                      torch.cat(peaks, dim=1).reshape(-1, 52).cpu().numpy())
    rec["sharded"]["card and CPU"] = {"mesh": [str(d) for d in mixed], "chunks": n_mixed, "seconds": m_wall,
                                      "launches": m_launches, **agree}
    print(f"sharded transcode (card and CPU, mesh {[str(d) for d in mixed]}): {n_mixed} x {chunk} stereo frames "
          f"encoded and phase 6's units decoded in {m_wall:.4f} s (the CPU shard on the plain versions); int16 "
          f"equal to phase 6's; units against phase 6's (CPU rows against card rows): {agree}; launches {m_launches}")
    del m_units, m_pcm, fields, peaks
    launches_sharded = rec["sharded"]["two shards on one card"]["launches"]

    # 10b. the sharded file paths against phase 9's files, killed and resumed
    mesh = meshes["two shards on one card"]
    p = {k: os.path.join(work, k) for k in ("in.wav", "out.aea", "out.wav", "mesh.aea", "mesh.wav", "ck.npz",
                                            "r.aea", "r.wav")}
    aea_bytes, wav_bytes = _read(p["out.aea"]), _read(p["out.wav"])
    _sync(dev)
    kernels.reset_launches()
    enc_wall, _ = _timed(lambda: encode_file(p["in.wav"], p["mesh.aea"], options, title="smoke", chunk_frames=chunk,
                                             mesh=mesh), dev)
    dec_wall, _ = _timed(lambda: decode_file(p["out.aea"], p["mesh.wav"], chunk_frames=chunk, mesh=mesh), dev)
    file_launches = dict(kernels.LAUNCHES)
    if _read(p["mesh.aea"]) != aea_bytes or _read(p["mesh.wav"]) != wav_bytes:
        raise AssertionError("sharded files: encode_file / decode_file with a mesh differ from phase 9's files")
    place = {"mesh": {"mesh": mesh}, "none": {"device": dev}}
    for run, src, out, ref, killed, resumed in (
            (encode_file, p["in.wav"], p["r.aea"], aea_bytes, "mesh", "mesh"),
            (encode_file, p["in.wav"], p["r.aea"], aea_bytes, "mesh", "none"),
            (decode_file, p["out.aea"], p["r.wav"], wav_bytes, "mesh", "mesh"),
            (decode_file, p["out.aea"], p["r.wav"], wav_bytes, "none", "mesh")):
        kw = dict(chunk_frames=chunk, checkpoint=p["ck.npz"], checkpoint_every=1)
        if run is encode_file:
            kw.update(options=options, title="smoke")
        try:
            run(src, out, on_progress=_KillAfter(2), **kw, **place[killed])
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("sharded files: the simulated kill did not happen")
        run(src, out, **kw, **place[resumed])
        if os.path.exists(p["ck.npz"]) or _read(out) != ref:
            raise AssertionError(f"sharded files: {run.__name__} killed ({killed}) and resumed ({resumed}) differs")
    rec["files"] = {"encode_file_seconds": enc_wall, "decode_file_seconds": dec_wall, "launches": file_launches}
    print(f"sharded files: encode_file {enc_wall:.4f} s and decode_file {dec_wall:.4f} s with mesh "
          f"{[str(d) for d in mesh]}, bytes equal to phase 9's; killed and resumed mesh -> mesh, mesh -> none "
          f"(encode) and none -> mesh (decode) byte-identical; launches {file_launches}")

    # 10c. the fast decoder: the golden fixture, then phase 6's units
    g_pcm, _ = decode_frames(unpack_frames(torch.tensor(golden_units, device=dev)), device=dev, fast=True)
    g_diff = np.abs(float_to_int16(g_pcm).cpu().numpy().reshape(-1).astype(np.int64) - golden)
    if g_diff.max() > 1 or (g_diff != 0).mean() >= 0.01:
        raise AssertionError(f"fast decode of the golden fixture: {int(g_diff.max())} LSB at most, "
                             f"{(g_diff != 0).mean():.4f} of samples differ")

    def fast_decode():
        st, outs = None, []
        for k in range(chunks):
            out, st = decode_frames(unpack_frames(units[:, k * chunk:(k + 1) * chunk]), st, device=dev, fast=True)
            outs.append(float_to_int16(out))
        return torch.cat(outs, dim=1)

    fast_decode()
    fast_pcm = fast_decode()
    f_diff = (fast_pcm.long() - pcm.long()).abs()
    if int(f_diff.max()) > 1:
        raise AssertionError(f"fast decode of phase 6's units: {int(f_diff.max())} int16 steps from the exact decode")
    fast_repeats = [_timed(fast_decode, dev)[0] for _ in range(3)]
    fast_ms = sorted(fast_repeats)[1] / chunks * 1e3
    fast_prof = _profile(
        lambda: float_to_int16(decode_frames(unpack_frames(units[:, :chunk]), device=dev, fast=True)[0]))
    rec["fast_decode"] = {"golden_max_lsb": int(g_diff.max()), "golden_share_differing": float((g_diff != 0).mean()),
                          "stream_max_lsb": int(f_diff.max()),
                          "stream_share_differing": float((f_diff != 0).double().mean()),
                          "repeat_seconds": fast_repeats, "ms_per_chunk": fast_ms, "profile_one_chunk": fast_prof,
                          "exact_ms_per_chunk": walls["decode"] / chunks * 1e3}
    print(f"fast decode: golden fixture within {int(g_diff.max())} LSB, {(g_diff != 0).mean():.5f} of samples differ; "
          f"phase 6's units within {int(f_diff.max())} LSB of the exact decode, "
          f"{rec['fast_decode']['stream_share_differing']:.5f} differ; {fast_ms:.3f} ms per stereo chunk (repeats "
          f"{', '.join(f'{r:.4f}' for r in fast_repeats)} s) against the exact decode's "
          f"{walls['decode'] / chunks * 1e3:.3f}; one chunk under the profiler: device busy "
          f"{fast_prof['device_ms']} ms in {fast_prof['device_launches']} launches")
    del g_pcm, fast_pcm, f_diff

    # 10d. the streams against encode_pcm / decode_units with the same chunk size
    stream_chunks, _ = chunk_frames_array(pcm16, chunk)                       # [chunks, 2, chunk, 512] int16
    enc_s, (fds, _) = _timed(lambda: encode_stream(stream_chunks, options, device=dev), dev)
    s_units = pack_frames(fds).transpose(0, 1).reshape(nch, nframes, 212).cpu().numpy()
    want_units = encode_pcm(pcm16.reshape(nch, -1), options, device=dev, chunk_frames=chunk)
    if not np.array_equal(interleave_stereo(s_units[0], s_units[1]), want_units):
        raise AssertionError("encode_stream: units differ from encode_pcm's")
    dec_s, (s_pcm, _) = _timed(lambda: decode_stream(fds, device=dev), dev)
    got = float_to_int16(s_pcm).transpose(0, 1).reshape(nch, -1)
    if _mismatch(got, decode_units(want_units, nch, device=dev, chunk_frames=chunk, to_i16=True))[0]:
        raise AssertionError("decode_stream: int16 differs from decode_units'")
    rec["streams"] = {"encode_stream_seconds": enc_s, "decode_stream_seconds": dec_s}
    print(f"streams: encode_stream {enc_s:.4f} s, decode_stream {dec_s:.4f} s over {chunks} x {chunk} stereo frames; "
          "units equal to encode_pcm's, int16 equal to decode_units'")
    del fds, s_pcm, got

    # 10e. the corpus: 8 stereo WAVs of a half chunk each and one file that is no WAV
    cdir = os.path.join(work, "corpus")
    out_dir, alone = os.path.join(cdir, "out"), os.path.join(cdir, "alone")
    for d in (cdir, out_dir, alone):
        os.makedirs(d, exist_ok=True)
    part = chunk // 2
    wavs = []
    for i in range(min(8, nframes // part)):
        wavs.append(os.path.join(cdir, f"part{i}.wav"))
        write_wav(wavs[-1], np.ascontiguousarray(pcm16[:, i * part:(i + 1) * part]).reshape(nch, -1))
    broken = os.path.join(cdir, "broken.wav")
    with open(broken, "wb") as f:
        f.write(b"this is no RIFF file")
    jobs = [(w, os.path.join(out_dir, os.path.basename(w)[:-4] + ".aea")) for w in wavs + [broken]]
    ck = os.path.join(cdir, "ck.json")
    place = {} if dev.type == "cuda" else {"device": dev}
    enc = transcode_corpus(jobs, options=options, chunk_frames=chunk, checkpoint_path=ck, **place)
    if enc.completed != wavs or list(enc.failed) != [broken] or os.path.exists(jobs[-1][1]):
        raise AssertionError(f"corpus encode: completed {enc.completed}, failed {list(enc.failed)}")
    djobs = [(o, o[:-4] + ".wav") for _, o in jobs[:-1]]
    dec = transcode_corpus(djobs, mode="decode", chunk_frames=chunk, **place)
    if len(dec.completed) != len(wavs) or dec.failed:
        raise AssertionError(f"corpus decode: completed {dec.completed}, failed {list(dec.failed)}")
    for (w, o), (_, d) in zip(jobs, djobs):
        encode_file(w, os.path.join(alone, "a.aea"), options, title=os.path.basename(o)[:-4], chunk_frames=chunk,
                    device=dev)
        decode_file(o, os.path.join(alone, "a.wav"), chunk_frames=chunk, device=dev)
        if _read(o) != _read(os.path.join(alone, "a.aea")) or _read(d) != _read(os.path.join(alone, "a.wav")):
            raise AssertionError(f"corpus: the outputs of {w} differ from encode_file / decode_file of it alone")
    again = transcode_corpus(jobs, options=options, chunk_frames=chunk, checkpoint_path=ck, **place)
    if again.skipped != wavs or again.completed or list(again.failed) != [broken]:
        raise AssertionError(f"corpus resume: skipped {again.skipped}, completed {again.completed}")

    # two processes of the launcher, gloo, both on the same device
    mh_out, mh_ck = os.path.join(cdir, "mh"), os.path.join(cdir, "mh.json")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join([root] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    port = _free_port()
    mh_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "carta1_tpu_torch.parallel.multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid), "--encode", os.path.join(cdir, "part*.wav"),
         "--out-dir", mh_out, "--checkpoint", mh_ck, "--device", mh_dev],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in range(2)]
    lines = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"multihost process exited {proc.returncode}: {err[-3000:]}")
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    mh_wall = time.perf_counter() - t0
    done = []
    for pid in range(2):
        with open(f"{mh_ck}.p{pid}") as f:
            done.append(set(json.load(f)["done"]))
    if (sorted(x["process"] for x in lines) != [0, 1] or any(x["processes"] != 2 or x["failed"] for x in lines)
            or not done[0].isdisjoint(done[1]) or done[0] | done[1] != set(wavs)):
        raise AssertionError(f"multihost: {lines}, checkpoints {done}")
    for w, o in jobs[:-1]:
        if _read(os.path.join(mh_out, os.path.basename(o))) != _read(o):
            raise AssertionError(f"multihost: the output of {w} differs from the corpus transcoder's")
    rec["corpus"] = {"files": len(wavs), "frames_per_file": part, "encode_seconds": enc.elapsed,
                     "encode_realtime_multiple": enc.realtime_multiple, "decode_seconds": dec.elapsed,
                     "decode_realtime_multiple": dec.realtime_multiple, "multihost": lines,
                     "multihost_wall_seconds": mh_wall, "multihost_split": [len(d) for d in done]}
    print(f"corpus: {len(wavs)} stereo WAVs of {part} frames ({os.path.getsize(wavs[0])} bytes each) and one broken "
          f"file: encode {enc.elapsed:.4f} s = {enc.realtime_multiple:.1f}x realtime, decode {dec.elapsed:.4f} s = "
          f"{dec.realtime_multiple:.1f}x realtime; outputs equal to each file alone; the broken file failed and left "
          f"no output; a second run skipped {len(again.skipped)}; multihost (2 gloo processes on {mh_dev}, "
          f"{mh_wall:.2f} s wall with start-up) split {[len(d) for d in done]}, disjoint and complete, "
          f"realtime multiples {[x['realtime_multiple'] for x in lines]}")
    rec["launches_sharded"] = launches_sharded
    return rec


def exact_phase(pcm16: np.ndarray, units: torch.Tensor, options, fixtures: str, golden_units: np.ndarray,
                golden: np.ndarray, dev: torch.device, check, rows: list, conv_rate: float) -> dict:
    """Phase 11: the exact engine on the card.  pcm16 is phase 6's stream
    ([2, F, 512] int16) and `units` its batched-engine units on the card;
    `check` is phase 3's kernel check, which appends K5's and K6's rows to
    `rows`."""
    from carta1_tpu_torch import EncoderOptions, decode_units, encode_pcm, kernels, testing
    from carta1_tpu_torch.gold import fftjs, transforms
    from carta1_tpu_torch.gold.encoder import (analysis_bands, encoder_init_state, exact_analysis, mdct_inputs,
                                               short_block_mask)
    from carta1_tpu_torch.io.aea import deinterleave_stereo
    from carta1_tpu_torch.ops import fftjs_kernels, heap_kernels
    from carta1_tpu_torch.ops.bitpack import unpack_frames
    from carta1_tpu_torch.ops.pcm import int16_to_float
    from carta1_tpu_torch.processor import _decode_batch_dev, _encode_batch_dev

    rec: dict = {}
    nch, nframes = pcm16.shape[:2]
    chunks = nframes // CHUNK
    expect = testing.exact_expect(os.path.join(fixtures, "torch_exact_expect.npz"))

    def upload(k: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(pcm16[:, k * CHUNK:(k + 1) * CHUNK])).to(dev)

    # 11a. the golden signal, from its stored input
    t0 = time.perf_counter()
    g_units = encode_pcm(expect["inputs"]["golden"].reshape(1, -1), device=dev, engine="exact")
    if not np.array_equal(g_units, golden_units):
        raise AssertionError(f"exact engine: golden signal's units differ from golden.aea in "
                             f"{int((g_units != golden_units).sum())} bytes")
    g_pcm = decode_units(g_units, 1, device=dev, to_i16=True, engine="exact").cpu().numpy().reshape(-1)
    if not np.array_equal(g_pcm, golden):
        raise AssertionError(f"exact engine: golden int16 differs in {int((g_pcm != golden).sum())} samples")

    # 11b. the classes and the bias variants, mono and as stereo pairs; 3-frame chunks
    checked = []
    for (name, bias), want in expect["units"].items():
        opts = EncoderOptions(allocation_bias=bias)
        got = encode_pcm(expect["inputs"][name].reshape(1, -1), opts, device=dev, engine="exact")
        if not np.array_equal(got, want):
            raise AssertionError(f"exact engine: {name} at bias {bias} differs from gold in "
                                 f"{int((got != want).sum())} bytes")
        checked.append(f"{name}@{bias}")
        if name != "golden" and bias == 1.0:
            thirds = encode_pcm(expect["inputs"][name].reshape(1, -1), device=dev, engine="exact", chunk_frames=3)
            if not np.array_equal(thirds, want):
                raise AssertionError(f"exact engine: {name} in 3-frame chunks differs from one chunk")
    classes = [c for c in testing.signals(1.0)]
    pairs = [((classes[i], 1.0), (classes[i + 1], 1.0)) for i in range(0, len(classes), 2)]
    pairs += [((testing.EXACT_BIAS_CLASSES[0], b), (testing.EXACT_BIAS_CLASSES[1], b)) for b in testing.EXACT_BIASES]
    for left, right in pairs:
        stereo = np.stack([expect["inputs"][left[0]].reshape(-1), expect["inputs"][right[0]].reshape(-1)])
        got = deinterleave_stereo(encode_pcm(stereo, EncoderOptions(allocation_bias=left[1]), device=dev,
                                             engine="exact"))
        if not (np.array_equal(got[0], expect["units"][left]) and np.array_equal(got[1], expect["units"][right])):
            raise AssertionError(f"exact engine: the stereo pair {left}, {right} differs from gold's units")
    rec["fixture"] = {"checked": checked, "stereo_pairs": [[list(a), list(b)] for a, b in pairs],
                      "seconds": time.perf_counter() - t0}
    print(f"exact engine: golden signal byte-equal to golden.aea ({golden_units.shape[0]} units), int16 equal to "
          f"golden_decode.npz; {len(checked) - 1} class and bias variants byte-equal to gold's units, mono, in "
          f"3-frame chunks and as {len(pairs)} stereo pairs ({rec['fixture']['seconds']:.2f} s)")

    # 11c. phase 6's stream through the exact engine, both states carried
    def transcode(plain: bool = False, n: int = chunks):
        est = dst = None
        u_out, p_out = [], []
        for k in range(n):
            u, est = _encode_batch_dev(upload(k), options, est, plain=plain, engine="exact")
            p, dst = _decode_batch_dev(u, dst, to_i16=True, plain=plain)
            u_out.append(u)
            p_out.append(p)
        return torch.cat(u_out, dim=1), torch.cat(p_out, dim=1)

    def encode_only():
        est, out = None, None
        for k in range(chunks):
            out, est = _encode_batch_dev(upload(k), options, est, engine="exact")
        return out

    transcode(n=1)                                                       # warm the tables
    _sync(dev)
    kernels.reset_launches()
    wall, (x_units, x_pcm) = _timed(transcode, dev)
    launches = dict(kernels.LAUNCHES)
    path = ("imdct_exact_64", "imdct_exact_256", "imdct_exact_512", "qmf_taps", "read_fields") + EXACT_KERNELS
    missing = [k for k in path if launches[k] == 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"exact engine: the stream launched no {missing}: {launches}")
    again_wall, (u2, p2) = _timed(transcode, dev)
    if _mismatch(x_units, u2)[0] or _mismatch(x_pcm, p2)[0]:
        raise AssertionError("exact engine: a second run gave other units or samples")
    plain_wall, (up, pp) = _timed(lambda: transcode(plain=True), dev)
    mu, mp = _mismatch(x_units, up)[0], _mismatch(x_pcm, pp)[0]
    if mu or mp:
        raise AssertionError(f"exact engine: {mu} unit bytes and {mp} int16 samples differ from the plain path")
    del u2, p2, up, pp
    repeats = [_timed(transcode, dev)[0] for _ in range(3)]
    enc_repeats = [_timed(encode_only, dev)[0] for _ in range(3)]
    ms = sorted(repeats)[1] / chunks * 1e3
    enc_ms = sorted(enc_repeats)[1] / chunks * 1e3
    prof = _profile(lambda: _encode_batch_dev(upload(0), options, None, engine="exact"))
    fx, fb = unpack_frames(x_units.reshape(-1, 212)), unpack_frames(units.reshape(-1, 212))
    equal = {k: float((getattr(fx, k) == getattr(fb, k)).double().mean()) for k in fx.fields()}

    # the transient scores' smallest distance to their thresholds, and their modes
    st, margin, modes = encoder_init_state(dev, nch), float("inf"), []
    for k in range(chunks):
        _, _, m, scores, st = exact_analysis(int16_to_float(upload(k)), st, options)
        for b in range(3):
            thr = options.band_thresholds[b]
            margin = min(margin, float(((scores[b] - thr).abs() / thr).min()))
        modes.append(m)
    if not torch.equal(torch.cat(modes, dim=1).reshape(-1, 3), fx.block_modes):
        raise AssertionError("exact engine: the analysis's block modes differ from the encoded units'")
    if margin < 1e-12:
        raise AssertionError(f"exact engine: a transient score lies {margin:.3e} (relative) from its threshold: "
                             "a last-ulp difference of a math library could flip its mode")
    cf = nch * nframes
    short = (fx.block_modes != 0).sum(dim=0).tolist()
    rec["stream"] = {"seconds": wall, "second_run_seconds": again_wall, "plain_seconds": plain_wall,
                     "repeat_seconds": repeats, "encode_repeat_seconds": enc_repeats, "ms_per_chunk": ms,
                     "encode_ms_per_chunk": enc_ms, "launches": launches, "profile_encode_one_chunk": prof,
                     "fields_equal_batched_engine": equal, "min_threshold_margin": margin, "short_frames": short}
    print(f"exact engine: transcode of {chunks} x {CHUNK} stereo frames (int16 -> exact encode -> units -> exact "
          f"decode -> int16) in {wall:.4f} s (second run {again_wall:.4f} s, repeats "
          f"{', '.join(f'{r:.4f}' for r in repeats)} s = {ms:.3f} ms per chunk, {cf / sorted(repeats)[1]:.1f} "
          f"channel-frames/s; plain versions {plain_wall:.4f} s); encode alone "
          f"{', '.join(f'{r:.4f}' for r in enc_repeats)} s = {enc_ms:.3f} ms per chunk; units and int16 equal to the "
          f"plain path and to a second run; launches {launches}")
    print(f"exact engine: one chunk's encode under the profiler: device busy {prof['device_ms']:.3f} ms of "
          f"{enc_ms:.3f} ms host wall (unprofiled) = idle share {1 - prof['device_ms'] / enc_ms:.3f}; "
          f"{prof['device_launches']} device launches; top: "
          + "; ".join(f"{o['name'][:40]} x{o['count']} {o['self_device_ms']:.3f} ms" for o in prof["ops"][:8]))
    print(f"exact engine: fields equal to phase 6's batched engine {equal}; short frames per band {short}; "
          f"smallest relative margin of a transient score to its threshold {margin:.6e}")

    # 11d. K5 and K6 against their plain versions at the first chunk's shapes and on edge inputs
    pcm0 = int16_to_float(upload(0))
    st0 = encoder_init_state(dev, nch)
    _, sf, modes0, _, _ = exact_analysis(pcm0, st0, options)
    sf = sf.reshape(-1, 52).contiguous()
    bands, _ = analysis_bands(pcm0, st0)
    long_in, short_in, _ = mdct_inputs(bands, st0)
    bias = options.allocation_bias
    heap_edges = [(torch.from_numpy(c).to(dev), x, budget)
                  for _, c, budget in testing.heap_edge_cases(heap_kernels.BLOCK_FRAMES) for x in (0.7, 1.0, 2.0)]
    print("alloc_heap: library_ms null -- no PyTorch call runs a budgeted greedy heap")
    check("alloc_heap", [(sf, bias)], heap_kernels.alloc_heap_plain, heap_kernels.alloc_heap,
          sf.numel() * 8 + 64 * 16 * 2 + 52 * 16 * 2, 0, reps=50,
          edge_cases=[(sf, b) for b in (0.7, 2.0)] + heap_edges)
    # what the time buys: each frame's serial chain, from the plain version on the same input
    counts: dict = {}
    heap_kernels.alloc_heap_plain(sf, bias, counts=counts)
    chain = counts["steps"] + counts["pops"] + counts["levels"]
    warps = torch.nn.functional.pad(chain, (0, -chain.numel() % heap_kernels.BLOCK_FRAMES)).view(
        -1, heap_kernels.BLOCK_FRAMES)
    per_frame = {k: float(v.double().mean()) for k, v in counts.items()}
    per_frame |= {"chain": float(chain.double().mean()), "warp_longest_chain": float(warps.amax(dim=1).double().mean())}
    rows[-1]["heap_per_frame"] = per_frame
    print(f"alloc_heap per frame of {sf.shape[0]}: accepted steps {per_frame['steps']:.2f}, pops {per_frame['pops']:.2f}, "
          f"sift levels compared {per_frame['levels']:.2f} (heapify included); chain (steps + pops + levels) "
          f"{per_frame['chain']:.2f}, mean over warps of a warp's longest chain {per_frame['warp_longest_chain']:.2f}; "
          f"{rows[-1]['ms'] * 1e6 / per_frame['warp_longest_chain']:.1f} ns per link of the longest chains")

    spectra = {128: torch.stack([bands[0], bands[1]]).reshape(-1, 128).contiguous(),
               256: bands[2].reshape(-1, 256).contiguous()}
    mdcts = {256: torch.stack(long_in[:2]).reshape(-1, 256).contiguous(), 512: long_in[2].reshape(-1, 512).contiguous()}

    def mdct_ops(rows_: int, n: int) -> int:
        return rows_ * (8 * n + 10 * (n // 2) * (n.bit_length() - 1) + 6 * n)

    # the short MDCT, masked by the frames' modes as the encoder runs it
    x64 = short_in.reshape(-1, 64).contiguous()
    active = short_block_mask(modes0).reshape(-1).contiguous()
    n_on, table_bytes = int(active.sum()), (32 + 2 * 15) * 8
    edges = [(torch.from_numpy(testing.edge_rows(b, 64, sd, 1e30)).to(dev), torch.from_numpy(m(b)).to(dev))
             for b, sd in testing.edge_cases(fftjs_kernels.ROWS[("mdct", 64)]) for m in testing.ROW_MASKS.values()]
    for x, _ in edges:
        if _mismatch(fftjs_kernels.mdct_js(x, 64), transforms.mdct_js_plain(x, 64))[0]:
            raise AssertionError(f"fft_js_mdct_64 unmasked: words differ from the plain version on {tuple(x.shape)}")
    check("fft_js_mdct_64", [(x64, active)], transforms.mdct_js_masked_plain, fftjs_kernels.mdct_js_masked,
          active.numel() + n_on * 64 * 4 + x64.shape[0] * 32 * 4 + table_bytes, mdct_ops(n_on, 16), reps=50,
          library=lambda: torch.fft.fft(x64), edge_cases=edges,
          conversions=_fftjs_conversions("mdct", n_on, 16))
    all_ms = kernels.time_ms(lambda: fftjs_kernels.mdct_js(x64, 64), 50)[0]
    all_bound = _bound_ms(x64.numel() * 6 + table_bytes, mdct_ops(x64.shape[0], 16), PEAK_F64_S,
                          _fftjs_conversions("mdct", x64.shape[0], 16), conv_rate)
    rows[-1] |= {"active_rows": n_on, "all_rows_ms": all_ms, "all_rows_bound_ms": all_bound[0],
                 "all_rows_bound_term": all_bound[2]}
    print(f"fft_js_mdct_64: {n_on} of {x64.shape[0]} rows active; every row transformed (the unmasked entry, "
          f"{len(edges)} edge inputs equal too) {all_ms:.4f} ms against a bound of {all_bound[0]:.4f} ({all_bound[2]})")
    for size in fftjs_kernels.MDCT_SIZES[1:]:
        x, n = mdcts[size], size // 4
        edges = [(torch.from_numpy(testing.edge_rows(b, size, sd, 1e30)).to(dev), size)
                 for b, sd in testing.edge_cases(fftjs_kernels.ROWS[("mdct", size)])]
        check(f"fft_js_mdct_{size}", [(x, size)], transforms.mdct_js_plain, fftjs_kernels.mdct_js,
              x.numel() * 4 * 3 // 2 + (size // 2 + 2 * (n - 1)) * 8, mdct_ops(x.shape[0], n), reps=50,
              library=lambda x=x: torch.fft.fft(x), edge_cases=edges,
              conversions=_fftjs_conversions("mdct", x.shape[0], n))
    for size in fftjs_kernels.SPECTRUM_SIZES:
        x, n = spectra[size], size
        ops = x.shape[0] * (10 * (n // 2) * (n.bit_length() - 1) + 4 * (n // 2))
        edges = [(torch.from_numpy(testing.edge_rows(b, size, sd, 1e30)).to(dev), size)
                 for b, sd in testing.edge_cases(fftjs_kernels.ROWS[("spectrum", size)])]
        check(f"fft_js_spectrum_{size}", [(x, size)], fftjs.magnitude_spectrum_js_plain,
              fftjs_kernels.magnitude_spectrum_js, x.numel() * 4 * 3 // 2 + 2 * (n - 1) * 8, ops, reps=50,
              library=lambda x=x: torch.fft.fft(x), edge_cases=edges,
              conversions=_fftjs_conversions("spectrum", x.shape[0], n))
    print("fft_js: library_ms is torch.fft.fft of the same rows (a speed reference: it rounds elsewhere); "
          f"conversions at {conv_rate / 1e12:.4f} T/s, measured in this run on {_smi()}")
    for row in rows:
        row["launches_exact"] = launches[row["name"]]
        if row["name"] in EXACT_KERNELS:
            row["launches"], row["launches_path"] = launches[row["name"]], "phase 11"
    return rec


def gold_surface_phase(pcm16: np.ndarray, units: torch.Tensor, pcm: torch.Tensor, options, dev: torch.device,
                       smi: str) -> dict:
    """Phase 12: the gold surface (`gold/transforms.py`, `gold/coding.py`)
    on the card, at the shapes the first chunk of phase 6's stream gives
    the exact engine (phase 11(c)): each function's kernel route against
    its plain route, then `on_progress` on encode_pcm / decode_units.
    pcm16 is phase 6's stream ([C, F, 512] int16), `units` and `pcm` its
    units and int16 on the card."""
    from carta1_tpu_torch import decode_units, encode_pcm, kernels
    from carta1_tpu_torch import constants as C
    from carta1_tpu_torch.gold import coding, transforms
    from carta1_tpu_torch.gold.encoder import (analysis_bands, encoder_init_state, exact_analysis, mdct_inputs,
                                               short_block_mask)
    from carta1_tpu_torch.ops import fftjs_kernels, imdct_kernels
    from carta1_tpu_torch.ops.pcm import int16_to_float

    t_phase = time.perf_counter()
    nch, nframes = pcm16.shape[:2]
    chunk = min(CHUNK, nframes)
    pcm0 = int16_to_float(torch.from_numpy(np.ascontiguousarray(pcm16[:, :chunk])).to(dev))
    st0 = encoder_init_state(dev, nch)
    bfu, sf, modes, _, _ = exact_analysis(pcm0, st0, options)
    bfu, sf = bfu.reshape(-1, C.NUM_BFUS, C.MAX_BFU_SIZE).contiguous(), sf.reshape(-1, C.NUM_BFUS).contiguous()
    bands, _ = analysis_bands(pcm0, st0)
    long_in, short_in, _ = mdct_inputs(bands, st0)
    x = {64: short_in.reshape(-1, 64).contiguous(), 256: torch.stack(long_in[:2]).reshape(-1, 256).contiguous(),
         512: long_in[2].reshape(-1, 512).contiguous()}
    spec = {size: transforms.mdct(v, size) for size, v in x.items()}
    spec[64] = spec[64][short_block_mask(modes).reshape(-1)].contiguous()      # the short blocks the encoder keeps
    low, mid, high = (b.reshape(nch, -1).contiguous() for b in bands)
    zero = torch.zeros(nch, C.QMF_DELAY, device=dev)
    wl = coding.allocate_bits_sf(sf, options.allocation_bias)
    quant = coding.quantize_js(bfu, sf, wl)
    bias = options.allocation_bias
    sizes = C.SPECS_PER_BFU

    # (name, call); each call takes plain and returns a tensor or a tuple of them
    cases = []
    for size in (64, 256, 512):
        for scale in (transforms.MDCT_SCALES[size], float(size)):
            cases.append((f"mdct_js({size}, {scale})", lambda p, s=size, c=scale: transforms.mdct_js(x[s], s, c, p)))
        for scale in (transforms.IMDCT_SCALES[size], None):
            cases.append((f"imdct_js({size}, {scale})",
                          lambda p, s=size, c=scale: transforms.imdct_js(spec[s], s, c, p)))
        cases.append((f"mdct({size})", lambda p, s=size: transforms.mdct(x[s], s, p)))
        cases.append((f"imdct({size})", lambda p, s=size: transforms.imdct(spec[s], s, p)))

    def synthesis(p):
        lows, d1 = transforms.qmf_synthesis_stream(low, mid, zero, p)
        return (lows, d1, *transforms.qmf_synthesis_stream(lows, high, zero, p))

    cases += [
        ("qmf_synthesis_stream", synthesis),
        ("allocate_bits", lambda p: coding.allocate_bits(bfu, sizes, bias, p)),
        ("allocate_bits_frame", lambda p: coding.allocate_bits_frame(bfu[1], sizes, bias, p)),
        ("allocate_bits_sweep", lambda p: coding.allocate_bits_sweep(sf, sizes, bias, p)),
        ("allocate_bits_sweep(2.0)", lambda p: coding.allocate_bits_sweep(sf, sizes, 2.0, p)),
    ]
    for _, call in cases:                                            # warm the tables
        call(False)
    _sync(dev)
    kernels.reset_launches()
    walls, got = {}, {}
    for name, call in cases:
        walls[name], got[name] = _timed(lambda: call(False), dev)
    launches = dict(kernels.LAUNCHES)
    path = ("imdct_exact_64", "imdct_exact_256", "imdct_exact_512", "qmf_taps", "alloc_reference", "alloc_heap",
            "fft_js_mdct_64", "fft_js_mdct_256", "fft_js_mdct_512")
    missing = [k for k in path if launches[k] == 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"gold surface: launched no {missing}: {launches}")
    differ = {}
    for name, call in cases:
        want = call(True)
        pairs = zip(got[name], want) if isinstance(want, tuple) else [(got[name], want)]
        differ[name] = sum(_mismatch(a, b)[0] for a, b in pairs)
    # no kernel: the same PyTorch ops on the card and on the CPU
    cpu = torch.device("cpu")
    prev, curr = spec[256][:, :16].contiguous(), spec[256][:, 16:32].contiguous()
    plain_pairs = {
        "overlap_add_js": (transforms.overlap_add_js(prev, curr),
                           transforms.overlap_add_js(prev.to(cpu), curr.to(cpu))),
        "find_scale_factors": (coding.find_scale_factors(bfu, C.BFU_SLOT_MASK),
                               coding.find_scale_factors(bfu.to(cpu), C.BFU_SLOT_MASK)),
        "dequantize_js": (coding.dequantize_js(quant, sf, wl),
                          coding.dequantize_js(quant.to(cpu), sf.to(cpu), wl.to(cpu))),
    }
    for name, (a, b) in plain_pairs.items():
        differ[name] = _mismatch(a.cpu(), b)[0]
    if not torch.equal(plain_pairs["find_scale_factors"][0], sf):
        raise AssertionError("gold surface: find_scale_factors differs from the exact encoder's scale factors")
    if any(differ.values()):
        raise AssertionError(f"gold surface: words differ from the plain route: {differ}")
    out = got["qmf_synthesis_stream"][2]
    if out.shape != (nch, chunk * 512) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"gold surface: QMF synthesis gave {tuple(out.shape)} or values that are not finite")
    # the stream in three calls, the delay carried, equals one call
    lows = got["qmf_synthesis_stream"][0]
    cut = [0, 1001, high.shape[1] // 2 + 3, high.shape[1]]
    parts, d = [], zero
    for a, b in zip(cut, cut[1:]):
        o, d = transforms.qmf_synthesis_stream(lows[:, a:b], high[:, a:b], d)
        parts.append(o)
    chained = _mismatch(torch.cat(parts, dim=-1), out)[0] + _mismatch(d, got["qmf_synthesis_stream"][3])[0]
    if chained:
        raise AssertionError(f"gold surface: the QMF synthesis in three calls differs from one call in {chained} words")

    # K1 and K6 at a scale other than the instance's: the same kernel, another table
    scale_ms = {}
    if dev.type == "cuda":
        for size in (256, 512):
            v, sp = x[size], spec[size]
            scale_ms[f"imdct_exact_{size}"] = [kernels.time_ms(lambda c=c: imdct_kernels.imdct_mid(sp, size, c), 20)[0]
                                               for c in (None, float(size))]
            scale_ms[f"fft_js_mdct_{size}"] = [kernels.time_ms(lambda c=c: fftjs_kernels.mdct_js(v, size, c), 20)[0]
                                               for c in (None, float(size))]

    # on_progress: the chunk calls of encode_pcm / decode_units on phase 6's prefix
    flat16 = pcm16.reshape(nch, -1)
    pre = min(2 * CHUNK, nframes)
    enc_calls, dec_calls, ragged_calls = [], [], []
    step = CHUNK * 5 // 8                                            # chunks that end off phase 6's
    pub_units = encode_pcm(flat16[:, :pre * 512], device=dev, chunk_frames=CHUNK,
                           on_progress=lambda d_, n: enc_calls.append((d_, n)))
    pub_pcm = decode_units(pub_units, nch, device=dev, chunk_frames=CHUNK, to_i16=True,
                           on_progress=lambda d_, n: dec_calls.append((d_, n)))
    ragged = decode_units(pub_units, nch, device=dev, to_i16=True, chunk_frames=step,
                          on_progress=lambda d_, n: ragged_calls.append((d_, n)))
    want_calls = [(min(k + CHUNK, pre), pre) for k in range(0, pre, CHUNK)]
    want_ragged = [(min(k + step, pre), pre) for k in range(0, pre, step)]
    if enc_calls != want_calls or dec_calls != want_calls or ragged_calls != want_ragged:
        raise AssertionError(f"on_progress: calls {enc_calls}, {dec_calls}, {ragged_calls}; want {want_calls}, "
                             f"{want_ragged}")
    want_units = units[:, :pre].cpu().numpy()
    if not all(np.array_equal(pub_units[ch::nch], want_units[ch]) for ch in range(nch)):
        raise AssertionError("on_progress: encode_pcm's units differ from phase 6's prefix")
    if _mismatch(pub_pcm, pcm[:, :pre].reshape(nch, -1))[0] or _mismatch(ragged, pub_pcm)[0]:
        raise AssertionError("on_progress: decode_units' int16 differs from phase 6's prefix")
    wall = time.perf_counter() - t_phase
    shapes = {s: [list(x[s].shape), list(spec[s].shape)] for s in x}
    print(f"gold surface: {len(cases)} kernel routes and {len(plain_pairs)} plain functions, 0 words differ from the "
          f"plain route (MDCT inputs and IMDCT spectra {shapes}, QMF streams {list(low.shape)} and "
          f"{list(high.shape)}, BFU data {list(bfu.shape)}); K1 and K6 at the instance scales and at gold's default "
          f"scales; the QMF stream in three calls equals one call; launches {launches}")
    print(f"gold surface walls on {smi} (ms, host clock, synchronised): "
          + "; ".join(f"{k} {v * 1e3:.4f}" for k, v in walls.items())
          + (f"; K1 / K6 at the instance scale and at scale = size (device ms): {scale_ms}" if scale_ms else ""))
    print(f"on_progress: encode_pcm {enc_calls}, decode_units {dec_calls} and at {step}-frame chunks {ragged_calls}; "
          f"units and int16 equal to phase 6's prefix; phase 12 took {wall:.1f} s")
    return {"launches": launches, "walls_s": walls, "differing_words": differ, "chained_differing_words": chained,
            "scale_ms": scale_ms, "on_progress": {"encode": enc_calls, "decode": dec_calls, "ragged": ragged_calls},
            "seconds": wall, "card": smi}


def contract_phase(pcm16: np.ndarray, units: torch.Tensor, pcm: torch.Tensor, options, work: str,
                   dev: torch.device, smi: str) -> dict:
    """Phase 13: the JAX package's calling contract on the card.  The calls
    a user of `carta1_tpu` writes, with its positional order (the engine
    third or fourth), against the same calls by keyword and against phases
    6 and 9: encode_file / decode_file on phase 9's files in `work`,
    encode_pcm / decode_units on phase 6's prefix, decode_frames with `fast`
    third; engine="exact" and "tpu".  pcm16 is phase 6's stream ([C, F,
    512] int16), `units` and `pcm` its units and int16 on the card."""
    from carta1_tpu_torch import decode_file, decode_frames, decode_units, encode_file, encode_pcm, kernels
    from carta1_tpu_torch.io.aea import read_aea
    from carta1_tpu_torch.ops.bitpack import unpack_frames

    t_phase = time.perf_counter()
    p = {k: os.path.join(work, k) for k in ("in.wav", "out.aea", "out.wav", "pos.aea", "kw.aea", "pos.wav", "kw.wav",
                                           "tpu.aea", "tpu.wav")}
    nch, nframes = pcm16.shape[:2]
    compared = []

    def holds(label: str, ok: bool) -> None:
        if not ok:
            raise AssertionError(f"calling contract: not {label}")
        compared.append(label)

    torch.cuda.synchronize()
    kernels.reset_launches()
    # the files: the exact engine named fourth (encode) and third (decode), then the batched one
    encode_file(p["in.wav"], p["pos.aea"], None, "exact")
    encode_file(p["in.wav"], p["kw.aea"], engine="exact")
    holds("encode_file(wav, aea, None, 'exact') == engine='exact'", _read(p["pos.aea"]) == _read(p["kw.aea"]))
    meta, exact_units = read_aea(p["pos.aea"])
    if meta.title != "" or exact_units.shape != (nch * nframes, 212):
        raise AssertionError(f"calling contract: exact encode_file wrote title {meta.title!r}, {exact_units.shape}")
    decode_file(p["pos.aea"], p["pos.wav"], "exact")
    decode_file(p["pos.aea"], p["kw.wav"], engine="exact")
    holds("decode_file(aea, wav, 'exact') == engine='exact'", _read(p["pos.wav"]) == _read(p["kw.wav"]))
    encode_file(p["in.wav"], p["tpu.aea"], options, "tpu", "smoke", CHUNK)
    holds("encode_file(wav, aea, options, 'tpu', 'smoke', CHUNK) == phase 9's file",
          _read(p["tpu.aea"]) == _read(p["out.aea"]))
    holds("exact units != the batched engine's", exact_units.tobytes() != read_aea(p["tpu.aea"])[1].tobytes())
    decode_file(p["out.aea"], p["tpu.wav"], "tpu", CHUNK)
    holds("decode_file(aea, wav, 'tpu', CHUNK) == phase 9's file", _read(p["tpu.wav"]) == _read(p["out.wav"]))

    # the streams on phase 6's prefix
    flat16 = pcm16.reshape(nch, -1)
    pre = min(2 * CHUNK, nframes)
    u_exact = encode_pcm(flat16[:, :pre * 512], options, "exact")
    holds("encode_pcm(pcm, options, 'exact') == engine='exact'",
          u_exact.tobytes() == encode_pcm(flat16[:, :pre * 512], options, engine="exact").tobytes())
    holds("encode_pcm exact == encode_file exact on the prefix", u_exact.tobytes() == exact_units[:nch * pre].tobytes())
    d_exact = decode_units(u_exact, nch, "exact")
    holds("decode_units(units, 2, 'exact') == engine='exact'",
          not _mismatch(d_exact, decode_units(u_exact, nch, engine="exact"))[0])
    u_tpu = encode_pcm(flat16[:, :pre * 512], options, "tpu", CHUNK)
    want_units = units[:, :pre].cpu().numpy()
    holds("encode_pcm(pcm, options, 'tpu', CHUNK) == phase 6's prefix",
          all(np.array_equal(u_tpu[ch::nch], want_units[ch]) for ch in range(nch)))
    holds("decode_units(units, 2, 'tpu', CHUNK, to_i16=True) == phase 6's prefix",
          not _mismatch(decode_units(u_tpu, nch, "tpu", CHUNK, to_i16=True), pcm[:, :pre].reshape(nch, -1))[0])

    # decode_frames with `fast` third
    fd = unpack_frames(torch.from_numpy(np.ascontiguousarray(u_tpu[0::nch][:CHUNK])).to(dev))
    fast, _ = decode_frames(fd, None, True)
    holds("decode_frames(fd, None, True) == fast=True", not _mismatch(fast, decode_frames(fd, fast=True)[0])[0])
    holds("decode_frames(fd, None, True) != fast=False", not torch.equal(fast, decode_frames(fd, None, False)[0]))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0 and k != "alloc_reference"]
    if missing:
        raise AssertionError(f"calling contract: the calls launched no {missing}: {launches}")
    wall = time.perf_counter() - t_phase
    print(f"calling contract: {len(compared)} JAX-order positional calls on {smi} equal to the keyword calls and "
          f"to phases 6 and 9 ({'; '.join(compared)}); launches {launches}; phase 13 took {wall:.1f} s")
    return {"compared": compared, "launches": launches, "seconds": wall, "card": smi}


def reference_phase(pcm16: np.ndarray, dev: torch.device, smi: str) -> dict:
    """Phase 14: phase 6's stream ([C, F, 512] int16) through the transcode
    with EncoderOptions(allocator="reference"), both states carried, the
    path of K4's alloc_reference at full width, timed and profiled in turns
    with phase 6's allocator (the host's pace drifts within a run); then
    the CLI's --allocator reference on the stream's first 256 frames
    against encode_pcm."""
    from carta1_tpu_torch import EncoderOptions, cli, encode_pcm, kernels
    from carta1_tpu_torch.io.aea import read_aea
    from carta1_tpu_torch.io.wav import write_wav
    from carta1_tpu_torch.ops.bitpack import unpack_frames
    from carta1_tpu_torch.processor import _decode_batch_dev, _encode_batch_dev

    t0 = time.perf_counter()
    allocators = {"reference": EncoderOptions(allocator="reference"), "rdo": EncoderOptions()}
    options = allocators["reference"]
    nch = pcm16.shape[0]

    def upload(k: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(pcm16[:, k * CHUNK:(k + 1) * CHUNK])).to(dev)

    def transcode(opts=options, plain: bool = False, chunks: int = CHUNKS):
        est = dst = None
        units_out, pcm_out = [], []
        for k in range(chunks):
            units, est = _encode_batch_dev(upload(k), opts, est, plain=plain)
            pcm, dst = _decode_batch_dev(units, dst, to_i16=True, plain=plain)
            units_out.append(units)
            pcm_out.append(pcm)
        return units_out, pcm_out

    transcode(chunks=1)                                               # the allocator's tables
    _sync(dev)
    kernels.reset_launches()
    wall, (units, pcm) = _timed(transcode, dev)
    launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0 and k not in PATHS and k != "alloc_rdo"]
    if missing or launches["alloc_reference"] != CHUNKS or launches["alloc_rdo"]:
        raise AssertionError(f"reference allocator's transcode: launches {launches} (no {missing})")
    units_p, pcm_p = transcode(plain=True)
    wl_diff = [int((unpack_frames(u.reshape(-1, 212)).word_lengths != unpack_frames(v.reshape(-1, 212)).word_lengths)
                   .sum()) for u, v in zip(units, units_p)]
    unit_diff = [_mismatch(u, v)[0] for u, v in zip(units, units_p)]
    pcm_diff = [_mismatch(u, v)[0] for u, v in zip(pcm, pcm_p)]
    if any(wl_diff) or any(unit_diff) or any(pcm_diff):
        raise AssertionError(f"reference allocator's transcode against plain=True, per chunk: word lengths {wl_diff}, "
                             f"unit bytes {unit_diff}, int16 samples {pcm_diff} differ")
    units_all = torch.cat(units, dim=1)
    if units_all.shape != (nch, CHUNK * CHUNKS, 212) or any(p.shape != (nch, CHUNK, 512) or p.dtype != torch.int16
                                                             for p in pcm):
        raise AssertionError(f"reference allocator's transcode: units {tuple(units_all.shape)}, int16 "
                             f"{[(tuple(p.shape), p.dtype) for p in pcm]}")
    word_lengths = unpack_frames(units_all.reshape(-1, 212)).word_lengths
    del units_p, pcm_p

    # walls and one chunk's encode under the profiler, the two allocators in turns
    repeats: dict = {name: [] for name in allocators}
    for order in (("rdo", "reference"), ("reference", "rdo"), ("rdo", "reference")):
        for name in order:
            repeats[name].append(_timed(lambda: transcode(allocators[name]), dev)[0])
    chunk_ms = {name: sorted(r)[1] / CHUNKS * 1e3 for name, r in repeats.items()}
    prof = {name: _profile(lambda: _encode_batch_dev(upload(0), allocators[name], None)) for name in ("rdo", "reference")}
    hand = {name: {h["name"]: h["device_ms"] for h in p["hand_kernels"]} for name, p in prof.items()}

    # the CLI, on the stream's first 256 frames as a WAV
    work = os.path.join("build", "chip_smoke_reference")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    wav, aea = os.path.join(work, "in.wav"), os.path.join(work, "cli.aea")
    head = np.ascontiguousarray(pcm16[:, :256]).reshape(nch, -1)
    write_wav(wav, head)
    if cli.main(["--encode", wav, aea, "--allocator", "reference", "--quiet"]) != 0:
        raise AssertionError("cli --allocator reference failed")
    _, cli_units = read_aea(aea)
    api_units = encode_pcm(head, options)
    if cli_units.shape != api_units.shape or not np.array_equal(cli_units, api_units):
        raise AssertionError("cli --allocator reference: units differ from encode_pcm's with the same options")
    shutil.rmtree(work)
    wall_s = time.perf_counter() - t0
    print(f"reference allocator: transcode of {CHUNKS} x {CHUNK} stereo frames with allocator='reference' in "
          f"{wall:.4f} s; word lengths per chunk against plain=True: {wl_diff} differ (units and int16 equal); "
          f"accepted steps per frame {word_lengths.sum(dim=1).double().mean().item():.2f}; launches {launches}")
    for name in ("reference", "rdo"):
        p = prof[name]
        print(f"reference allocator: allocator={name!r} in turns, repeats "
              f"{', '.join(f'{r:.4f}' for r in repeats[name])} s = {chunk_ms[name]:.3f} ms per chunk (median); one "
              f"chunk's encode under the profiler: device busy {p['device_ms']:.3f} ms in {p['device_launches']} "
              f"launches, hand kernels {hand[name]}; on {smi}")
    print(f"reference allocator: cli --allocator reference on {head.shape[1] // 512} frames x {nch} equal to "
          f"encode_pcm's {api_units.shape[0]} units; phase 14 took {wall_s:.1f} s")
    return {"seconds": wall, "repeat_seconds": repeats, "ms_per_chunk": chunk_ms, "launches": launches,
            "word_lengths_differing": wl_diff, "profile_encode": prof, "cli_units": int(api_units.shape[0]),
            "accepted_steps_per_frame": float(word_lengths.sum(dim=1).double().mean()), "wall_s": wall_s, "card": smi}


def harness_phase(dev: torch.device) -> dict:
    """Phase 15: each module of carta1_tpu_torch.harness once on the card;
    returns every JSON line they printed, the launches and the walls."""
    from carta1_tpu_torch import decode_units, encode_pcm, kernels
    from carta1_tpu_torch.harness import bench, bench_scaling, profile_stages, quality_report

    walls = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    head, (units, pcm) = bench.run(device=dev)
    walls["bench"] = time.perf_counter() - t0
    # the chunk the headline timed, against the public entry points
    pcm16 = bench.stereo_chunk(bench.CHUNK)
    want = encode_pcm(pcm16.reshape(2, -1), chunk_frames=bench.CHUNK)
    got = units.cpu().numpy()
    if not (np.array_equal(got[0], want[0::2]) and np.array_equal(got[1], want[1::2])):
        raise AssertionError("harness bench: the first chunk's units differ from encode_pcm's")
    if _mismatch(pcm.reshape(2, -1), decode_units(want, 2, chunk_frames=bench.CHUNK, to_i16=True))[0]:
        raise AssertionError("harness bench: the first chunk's int16 differs from decode_units'")
    chains = head["transcode_chains"]
    print(f"harness bench: {head['value']:.1f} channel-frames/s resident (median of {chains['repeats']}, "
          f"{chains['fps2_spread']['min']:.1f}-{chains['fps2_spread']['max']:.1f}), pageable "
          f"{chains['pageable']['fps']['median']:.1f}; one chunk {chains['one_chunk']['host_wall_ms']:.3f} ms, "
          f"busy {chains['one_chunk']['device_busy_ms']:.3f} ms, idle share {chains['one_chunk']['idle_share']:.3f}; "
          f"encode_file {head['encode_corpus_fps']:.1f}, decode_file {head['decode_corpus_fps']:.1f} channel-frames/s; "
          f"vs_baseline {head['vs_baseline']:.3f} (baseline {head['baseline']['fps']['median']:.1f} frames/s on the "
          f"CPU, one thread); first chunk equal to encode_pcm -> decode_units; {walls['bench']:.1f} s")

    t0 = time.perf_counter()
    stages, _ = profile_stages.run(device=dev)
    walls["profile_stages"] = time.perf_counter() - t0
    for key in ("stages", "decode_substages"):
        print(f"harness profile_stages, {key} (host ms / busy ms / launches per call of {stages['frames']} frames): "
              + "; ".join(f"{k} {r['host_ms_per_call']:.3f} / {r['device_busy_ms']:.3f} / {r['device_launches']}"
                          for k, r in stages[key].items()))

    t0 = time.perf_counter()
    quality = quality_report.run(device=dev)
    walls["quality_report"] = time.perf_counter() - t0
    worst = quality[-1]["value"]
    print("harness quality_report (gold / batched dB): " + "; ".join(
        f"{r['signal']} {r['psnr_reference_encoder_db']:.3f} / {r['psnr_tpu_encoder_db']:.3f}" for r in quality[:-1])
        + f"; worst delta {worst:.4f} dB")
    if worst < 0:
        raise AssertionError(f"harness quality_report: the batched encoder is {-worst} dB under gold on a class")

    t0 = time.perf_counter()
    scaling, _ = bench_scaling.run(device=dev)
    walls["bench_scaling"] = time.perf_counter() - t0
    print("harness bench_scaling (channel-frames/s, median): " + "; ".join(
        f"{r['kind']} {r['mesh']} {r['fps2']:.1f}" for r in scaling))

    # in a process of its own: its peak RSS is the whole process's
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    proc = subprocess.run([sys.executable, "-m", "carta1_tpu_torch.harness.stream_stress", "--minutes",
                           str(STRESS_MINUTES)], cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"harness stream_stress: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    stress = json.loads(proc.stdout.strip().splitlines()[-1])
    walls["stream_stress"] = time.perf_counter() - t0
    print(f"harness stream_stress ({stress['reduced']}): {stress['wav_mb']:.1f} MB WAV, encode "
          f"{stress['encode']['channel_frames_per_s']:.1f} and decode {stress['decode']['channel_frames_per_s']:.1f} "
          f"channel-frames/s, peak RSS {stress['rss_mb']['peak']:.1f} MB "
          f"({stress['rss_mb']['growth_past_warm']:.1f} MB past the warm run), card peak {stress['device_peak_allocated_mb']:.1f} MB allocated")

    launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0 and k != "alloc_reference"]
    if missing:
        raise AssertionError(f"harness: launched no {missing}: {launches}")
    print(f"harness: launches {launches}; walls {', '.join(f'{k} {v:.1f} s' for k, v in walls.items())}")
    return {"bench": head, "profile_stages": stages, "quality_report": quality, "bench_scaling": scaling,
            "stream_stress": stress, "launches": launches, "walls_s": walls}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=os.path.join("build", "chip_smoke.json"),
                        help="where to write the full JSON record")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the GPU", file=sys.stderr)
        return 2

    from carta1_tpu_torch import EncoderOptions, decode_units, encode_frames, encode_pcm, kernels, probe_rates, testing
    from carta1_tpu_torch import constants as C
    from carta1_tpu_torch.constants import QMF_EVEN, QMF_ODD
    from carta1_tpu_torch.io.aea import read_aea
    from carta1_tpu_torch.ops import bitalloc_kernels, bitpack, bitpack_kernels, imdct_kernels, qmf_kernels
    from carta1_tpu_torch.ops.pcm import float_to_int16, int16_to_float
    from carta1_tpu_torch.pipeline.encoder import analysis_step, encoder_init_state
    from carta1_tpu_torch.processor import _decode_batch_dev, _encode_batch_dev, pcm_to_frames
    from carta1_tpu_torch.tables import RDO_BUDGET

    dev = torch.device("cuda")
    record: dict = {}

    # 1. environment
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")
    record["card"] = smi

    # 2. build (all nvcc runs at once), the kernels and the rate probe
    libraries = kernels.LIBRARIES + ("probe_rates",)
    build_s = kernels.build(libraries)
    print(f"build: {build_s:.2f} s for {', '.join(libraries)}")
    for lib, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {lib}: {line.strip()}")
    record["build_s"] = build_s

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
    _, golden_units = read_aea(os.path.join(fixtures, "golden.aea"))
    stream = _stereo_stream(golden_units)
    options = EncoderOptions()

    # main-path input: 4 x 8192 stereo frames of tones, noise and periodic
    # transients, as the int16 samples a WAV file would hold
    source = testing.synth_audio(CHUNK * CHUNKS, 2)                      # f32 [2, N]
    pcm16 = float_to_int16(torch.from_numpy(source)).numpy().reshape(2, CHUNK * CHUNKS, 512)

    def upload(k: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(pcm16[:, k * CHUNK:(k + 1) * CHUNK])).to(dev)

    # the first chunk gives the kernels their main-path shapes
    chunk, _ = _encode_batch_dev(upload(0), options, None)               # uint8 [2, 8192, 212]
    modes = bitpack.unpack_frames(chunk.reshape(-1, 212)).block_modes != 0
    n_short = modes.sum(dim=0).tolist()
    n64 = 4 * n_short[0] + 4 * n_short[1] + 8 * n_short[2]
    if n64 == 0:
        raise AssertionError("the encoder chose no short-mode frame in the smoke stream's first chunk")
    frames = 2 * CHUNK
    print(f"first transcode chunk: short frames per band {n_short} of {frames}")

    # 3. kernels against their plain versions, at main-path shapes
    rng = np.random.default_rng(2024)
    rows = []

    def check(kname, cases, plain_fn, kernel_fn, nbytes, ops, reps, library=None, edge_cases=(), rate=PEAK_F64_S,
              conversions=0):
        bad, err = 0, 0.0
        for case in edge_cases:
            m, _ = _mismatch(kernel_fn(*case), plain_fn(*case))
            if m:
                raise AssertionError(f"{kname}: {m} words differ from the plain version on the edge input "
                                     f"{[tuple(t.shape) if isinstance(t, torch.Tensor) else t for t in case]}")
        for case in cases:
            got = kernel_fn(*case)
            want = plain_fn(*case)
            torch.cuda.synchronize()
            m, e = _mismatch(got, want)
            bad, err = bad + m, max(err, e)
        if bad:
            raise AssertionError(f"{kname}: {bad} words differ from the plain version (max abs {err})")
        ms, host_ms = kernels.time_ms(lambda: [kernel_fn(*a) for a in cases], reps)
        plain_ms, _ = kernels.time_ms(lambda: [plain_fn(*a) for a in cases], max(2, reps // 10), warmup=1)
        lib_ms = kernels.time_ms(library, reps)[0] if library is not None else None
        bound, by, term = _bound_ms(nbytes, ops, rate, conversions, conv_rate)
        src, replaces = kernels.KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": f"carta1_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms, "host_ms": host_ms,
            "bound_term": term, "bytes": nbytes, "arith_ops": ops, "conversions": conversions,
            "shapes": [[list(t.shape) for t in a if isinstance(t, torch.Tensor)] for a in cases],
        })
        print(f"{kname}: 0 words differ from the plain version ({len(edge_cases)} edge inputs too); kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms {bound:.4f} ({term}) "
              f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)}")

    empty_ms, empty_host_ms = kernels.time_ms(lambda: kernels.empty_launch(dev), 200)
    print(f"empty launch through ctypes: {empty_ms:.4f} ms on the device, {empty_host_ms:.4f} ms of host time, "
          "each, back to back on one stream")
    record["empty_launch_ms"] = {"device": empty_ms, "host": empty_host_ms}

    # the conversion rate that bounds K1 and K6, from the round-trip loop of csrc/probe_rates.cu
    probe = probe_rates.measure(("dadd", "round+widen", "dadd & round+widen"))
    conv_rate = probe_rates.conversion_rate(probe["round+widen"])
    dadd_rate = probe_rates.PER_LAUNCH / (probe["dadd"] * 1e-3)
    print(f"rates on {smi}: f32 <-> f64 conversions {conv_rate / 1e12:.4f} T/s (a rounding and a widening count "
          f"apart), unfused f64 adds {dadd_rate / 1e12:.4f} T/s; both mixed {probe['dadd & round+widen']:.4f} ms "
          f"against {probe['dadd']:.4f} + {probe['round+widen']:.4f} ms apart")
    record["rates"] = {"card": smi, "ms": probe, "conversions_per_s": conv_rate, "dadd_per_s": dadd_rate}

    for size, batch in ((64, n64), (256, 2 * frames), (512, frames)):
        x = _spectra(rng, batch, size // 2, dev)
        edges = [(torch.from_numpy(testing.imdct_edge_spectra(size, b, sd)).to(dev), size)
                 for b, sd in testing.edge_cases(imdct_kernels.TILE[size])]
        n = size // 4
        ops = batch * (12 * n + 10 * (n // 2) * (n.bit_length() - 1))
        table_bytes = (size // 2) * 8 + 2 * (n - 1) * 8
        check(f"imdct_exact_{size}", [(x, size)], imdct_kernels.imdct_mid_plain,
              imdct_kernels.imdct_mid, x.numel() * 8 + table_bytes, ops, reps=50, edge_cases=edges,
              library=lambda x=x: torch.fft.fft(x), conversions=_imdct_conversions(batch, n))

    works = [(torch.from_numpy(rng.standard_normal((frames, 46 + 2 * s)).astype(np.float32)).to(dev),)
             for s in (128, 256)]
    print("imdct_exact: library_ms is torch.fft.fft of the same rows, as for fft_js (a speed reference only: no "
          f"PyTorch call computes these bits, an FFT-based IMDCT rounds at other points); on {smi}")
    # speed reference only: conv1d sums K2's taps in another order
    synth = torch.zeros((2, 1, 48), dtype=torch.float64, device=dev)
    synth[0, 0, 1::2] = torch.from_numpy(QMF_ODD.astype(np.float64))
    synth[1, 0, 0::2] = torch.from_numpy(QMF_EVEN.astype(np.float64))
    works64 = [w[0].double().unsqueeze(1) for w in works]
    check("qmf_taps", works, qmf_kernels.qmf_taps_plain, qmf_kernels.qmf_taps,
          sum(w[0].numel() * 4 + frames * (w[0].shape[1] - 46) * 4 for w in works) + 48 * 8,
          sum(frames * (w[0].shape[1] - 46) // 2 * 96 for w in works), reps=50,
          library=lambda: [torch.nn.functional.conv1d(w, synth, stride=2) for w in works64],
          edge_cases=[(torch.from_numpy(testing.qmf_edge_work(b, s, sd)).to(dev),)
                      for s in (2, 7, 128, 256) for b, sd in testing.edge_cases(qmf_kernels.tile_rows(s))]
          + [(torch.from_numpy(testing.qmf_edge_work(5, 611, 0)).to(dev),)])      # more than one column tile

    reads = bitpack.field_reads(chunk.reshape(-1, 212))
    read_bytes = reads[0][0].numel() * 4 + sum(r[1].numel() * 12 for r in reads)
    anchors = [(r[1] >> 4).clamp(0, 127).long() for r in reads]
    win64 = reads[0][0].long()
    check("read_fields", reads, bitpack_kernels.read_fields_plain, bitpack_kernels.read_fields,
          read_bytes, 0, reps=50,
          library=lambda: [torch.gather(win64, 1, h) for h in anchors])

    # K4, both allocators, on that chunk's coefficients and scale factors
    bfu, sf, _, _ = analysis_step(int16_to_float(upload(0)), encoder_init_state(dev, 2), options.band_thresholds)
    bfu = bfu.reshape(-1, C.NUM_BFUS, C.MAX_BFU_SIZE).contiguous()
    sf = sf.reshape(-1, C.NUM_BFUS).contiguous()
    bias = options.allocation_bias
    alloc_edges = [(torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev))
                   for _, b, s in testing.alloc_edge_cases(bitalloc_kernels.BLOCK_FRAMES)]
    # f32 operations on this run's inputs: 9 per coefficient and word length
    # of every BFU with a nonzero scale factor (mul, add, trunc, max, min,
    # mul, sub, mul, add), and per such BFU 16 weight multiplies, 15 slope
    # subtracts and multiplies and 14 maxima of the hull
    active = sf > 0
    coeffs = int((active.long() * torch.from_numpy(C.SPECS_PER_BFU).to(dev)).sum())
    rdo_ops = 16 * 9 * coeffs + 60 * int(active.sum())
    out_bytes = sf.numel() * 4
    print("alloc_rdo, alloc_reference: library_ms null -- no PyTorch call computes a budgeted greedy allocation")
    check("alloc_rdo", [(bfu, sf, bias)], bitalloc_kernels.alloc_rdo_plain, bitalloc_kernels.alloc_rdo,
          bfu.numel() * 4 + sf.numel() * 4 + out_bytes, rdo_ops, reps=50, rate=PEAK_F32_S,
          edge_cases=[(bfu, sf, b) for b in (0.7, 2.0)] + [(b, s, x) for b, s in alloc_edges for x in (0.7, 1.0, 2.0)])
    mixed = [torch.from_numpy(testing.reference_mixed_rows(f, f)).to(dev)
             for f in (1, bitalloc_kernels.BLOCK_FRAMES + 1, 6 * bitalloc_kernels.BLOCK_FRAMES + 5)]
    check("alloc_reference", [(sf, bias)], bitalloc_kernels.alloc_reference_plain, bitalloc_kernels.alloc_reference,
          sf.numel() * 4 + out_bytes, 0, reps=50,
          edge_cases=[(sf, b) for b in (0.7, 2.0)] + [(s, x) for s in [s for _, s in alloc_edges] + mixed
                                                      for x in (0.7, 1.0, 2.0)])
    keys = torch.randint(0, 2**30, (frames, 780), dtype=torch.int32, device=dev)
    sort_ms = kernels.time_ms(lambda: torch.sort(keys, dim=-1), 20)[0]
    rows[-2]["sort_ms"] = rows[-1]["sort_ms"] = sort_ms
    # with no budget every head is dropped before the first pop: the error curves and hulls alone
    rows[-2]["curves_ms"] = kernels.time_ms(lambda: bitalloc_kernels.alloc_rdo(bfu, sf, bias, budget=0), 50)[0]
    print(f"alloc_rdo split: error curves and hulls {rows[-2]['curves_ms']:.4f} ms (a budget of 0), the merge about "
          f"{rows[-2]['ms'] - rows[-2]['curves_ms']:.4f} ms; alloc_reference, its ranks alone, {rows[-1]['ms']:.4f} ms")
    wl = bitalloc_kernels.alloc_rdo(bfu, sf, bias)
    wl_ref = bitalloc_kernels.alloc_reference(sf, bias)
    # what alloc_reference's time buys: its first design merged every accepted
    # step, each raising one word length by one, in one warp per frame
    steps = wl_ref.sum(dim=1).double()
    ref_row = rows[-1]
    ref_row["chain_per_frame"] = {"steps": float(steps.mean()), "warp_longest_chain": float(steps.max()),
                                  "ns_per_link": ref_row["ms"] * 1e6 / float(steps.mean()),
                                  "ns_per_link_longest": ref_row["ms"] * 1e6 / float(steps.max()), "card": smi}
    # this design's chain, counted by its NumPy model on the same input: one
    # reduction per bisection step, the steps of the prefix's rank, one per
    # pop of the merge and the merge's last, empty one
    counts: dict = {}
    model = testing.bisect_sweep_reference(sf.cpu().numpy(), bitalloc_kernels.reference_tables(bias), RDO_BUDGET,
                                           counts=counts)
    if not np.array_equal(model, wl_ref.cpu().numpy()):
        raise AssertionError("alloc_reference: the NumPy model of the kernel differs from the kernel")
    links = counts["steps"] + 1 + counts["pops"] + 1
    longest = int(links.argmax())
    one = sf[longest:longest + 1]
    one_ms = kernels.time_ms(lambda: bitalloc_kernels.alloc_reference(one, bias), 200)[0]
    ref_row["bisect_chain_per_frame"] = {
        "bisection_steps": float(counts["steps"].mean()), "rank_group": float(counts["group"].mean()),
        "pops": float(counts["pops"].mean()), "pops_max": int(counts["pops"].max()), "links": float(links.mean()),
        "links_max": int(links.max()), "ns_per_link": ref_row["ms"] * 1e6 / float(links.mean()),
        "one_frame_ms": one_ms, "serial_ms": one_ms - empty_ms,
        "ns_per_link_alone": (one_ms - empty_ms) * 1e6 / int(links[longest]), "card": smi}
    chain = ref_row["bisect_chain_per_frame"]
    print(f"alloc_reference: bisected prefix, then the merge; per frame {chain['bisection_steps']:.0f} bisection "
          f"steps, {chain['rank_group']:.2f} steps at the prefix's rank, {chain['pops']:.3f} pops (at most "
          f"{chain['pops_max']}): {chain['links']:.2f} links, {chain['ns_per_link']:.1f} ns each at {frames} frames; "
          f"the frame with the most links ({chain['links_max']}) alone {one_ms:.4f} ms, {chain['serial_ms']:.4f} past "
          f"an empty launch ({chain['ns_per_link_alone']:.1f} ns per link: the serial term); on {smi}")
    print(f"alloc_rdo: main-path inputs [{frames}, {C.NUM_BFUS}, {C.MAX_BFU_SIZE}] f32 + [{frames}, {C.NUM_BFUS}] i32; "
          f"{active.float().mean().item():.3f} of BFUs with a scale factor, {coeffs} coefficients; accepted steps per "
          f"frame {wl.float().sum(dim=1).mean().item():.2f} (reference allocator "
          f"{wl_ref.float().sum(dim=1).mean().item():.2f}); torch.sort of [{frames}, 780] int32, the plain "
          f"version's sort, alone: {sort_ms:.4f} ms (speed reference)")
    del bfu, sf, alloc_edges, mixed, keys, wl, wl_ref, one

    # 4. golden fixture, int16-exact on the card
    golden = np.load(os.path.join(fixtures, "golden_decode.npz"))["int16"]
    got = decode_units(golden_units, 1, to_i16=True).cpu().numpy().reshape(-1)
    if not np.array_equal(got, golden):
        raise AssertionError(f"golden int16 differs in {(got != golden).sum()} samples")
    print(f"golden fixture: {golden.size} int16 samples equal")

    # 5. the encoder on the card against the gold engine's fixture
    expect = np.load(os.path.join(fixtures, "torch_encode_expect.npz"))
    bits_of = torch.from_numpy(C.WORD_LENGTH_BITS.astype(np.int64)).to(dev)
    specs = torch.from_numpy(C.SPECS_PER_BFU.astype(np.int64)).to(dev)
    enc_rows = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for cls, sig in testing.signals(float(expect["seconds"])).items():
        fr = pcm_to_frames(sig)
        ref_card, _ = encode_frames(fr, EncoderOptions(allocator="reference"))
        bfu, _, _, _ = analysis_step(torch.from_numpy(fr).to(dev), encoder_init_state(dev), options.band_thresholds)
        peaks = torch.where(torch.from_numpy(C.BFU_SLOT_MASK).to(dev), bfu.abs(), 0.0).amax(dim=-1).cpu().numpy()
        ref_cpu, _ = encode_frames(fr, EncoderOptions(allocator="reference"), device="cpu")
        gold_modes = expect[f"{cls}/block_modes"].astype(np.int32)
        gold_sf = expect[f"{cls}/scale_factors"].astype(np.int32)
        mode_flips = {
            "card_vs_gold": int((ref_card.block_modes.cpu().numpy() != gold_modes).any(axis=1).sum()),
            "cpu_vs_gold": int((ref_cpu.block_modes.numpy() != gold_modes).any(axis=1).sum()),
            "card_vs_cpu": int((ref_card.block_modes.cpu() != ref_cpu.block_modes).any(dim=1).sum()),
        }
        sf_card = ref_card.scale_factors.cpu().numpy()
        sf_diff = {"card_vs_gold": int((sf_card != gold_sf).sum()),
                   "card_vs_jax_cpu": int((sf_card != expect[f"{cls}/scale_factors_jax_cpu"]).sum()),
                   "card_vs_cpu": int((sf_card != ref_cpu.scale_factors.numpy()).sum()),
                   "jax_cpu_vs_gold": int((expect[f"{cls}/scale_factors_jax_cpu"] != gold_sf).sum()),
                   "of": int(gold_sf.size)}
        sf_faults = testing.scale_factor_faults(sf_card, gold_sf, peaks)
        if mode_flips["card_vs_gold"] or sf_faults:
            raise AssertionError(f"encode {cls}: {mode_flips} frames with other block modes; {sf_faults} scale factors "
                                 f"differ from the gold engine's beyond a peak's rounding across a table value ({sf_diff})")
        fd_card, _ = encode_frames(fr)
        fd_cpu, _ = encode_frames(fr, device="cpu")
        used_bits = (bits_of[fd_card.word_lengths.long()] * specs).sum(dim=-1)
        if int(used_bits.max()) + 40 + 10 * C.NUM_BFUS > C.FRAME_BITS:
            raise AssertionError(f"encode {cls}: a frame spends {int(used_bits.max())} bits, over the budget")
        out = decode_units(bitpack.pack_frames(fd_card).cpu().numpy(), 1).cpu().numpy().reshape(-1)
        p_card, p_gold = testing.psnr(sig, out), float(expect[f"{cls}/psnr_gold"])
        if not p_card >= p_gold:
            raise AssertionError(f"encode {cls}: round-trip PSNR {p_card:.3f} dB below the gold encoder's {p_gold:.3f}")
        same = {k: float((getattr(fd_card, k).cpu() == getattr(fd_cpu, k)).float().mean()) for k in fd_card.fields()}
        same_ref = {k: float((getattr(ref_card, k).cpu() == getattr(ref_cpu, k)).float().mean()) for k in ref_card.fields()}
        enc_rows[cls] = {"psnr_card_db": p_card, "psnr_gold_db": p_gold,
                         "psnr_jax_cpu_db": float(expect[f"{cls}/psnr_jax_cpu"]),
                         "mode_flips": mode_flips, "scale_factor_diffs": sf_diff, "max_bits": int(used_bits.max()),
                         "fields_equal_card_cpu": same, "fields_equal_card_cpu_reference_allocator": same_ref}
        print(f"encode {cls}: modes equal gold's, scale factors differ in {sf_diff} (each one off, peak on a table "
              f"value); PSNR {p_card:.3f} dB >= gold {p_gold:.3f} "
              f"(JAX on CPU {enc_rows[cls]['psnr_jax_cpu_db']:.3f}); most bits in a frame {int(used_bits.max())} of {RDO_BUDGET}; "
              f"mode flips {mode_flips}; equal to the CPU run: word_lengths {same['word_lengths']:.4f} "
              f"quantized {same['quantized']:.6f} scale_factors {same['scale_factors']:.4f}")
    record["encode_checks"] = enc_rows
    launches_p5 = dict(kernels.LAUNCHES)
    if not (launches_p5["alloc_reference"] and launches_p5["alloc_rdo"]):
        raise AssertionError(f"encoder checks launched not both allocators: {launches_p5}")
    print(f"encoder checks: launches {launches_p5}")
    record["launches_phase5"] = launches_p5
    chain = next(r for r in rows if r["name"] == "alloc_reference")["chain_per_frame"]
    print(f"alloc_reference per frame of phase 3's main-path chunk ({frames} frames, one warp each): accepted steps "
          f"(the sum of its word lengths, the first design's chain of pops) {chain['steps']:.2f} mean over warps, "
          f"{chain['warp_longest_chain']:.0f} the largest; phase 3's {frames}-frame time per accepted step "
          f"{chain['ns_per_link']:.1f} ns of the mean chain, {chain['ns_per_link_longest']:.1f} of the longest; on {smi}")

    # what ceil(3 * (log2(a) + 21)) in f32 makes of amplitudes around every table
    # value, on the card and on the CPU, against the table comparison the port uses
    amps = torch.from_numpy(testing.scale_factor_edge_amplitudes())

    def by_log2(a: torch.Tensor) -> torch.Tensor:
        return torch.ceil(3.0 * (torch.log2(a.clamp(min=1e-38)) + 21.0)).clamp(0, 63).to(torch.int32)

    sf64 = torch.from_numpy(C.SCALE_FACTORS)
    by_table = torch.bucketize(amps.double(), sf64).clamp(max=63).to(torch.int32)
    log2_flips = {"card": int((by_log2(amps.to(dev)).cpu() != by_table).sum()),
                  "cpu": int((by_log2(amps) != by_table).sum()), "of": amps.numel()}
    print(f"scale factors: f32 log2 formula differs from the f64 table comparison on {log2_flips['card']} (card) / "
          f"{log2_flips['cpu']} (CPU) of {log2_flips['of']} amplitudes within 4 ulps of a table value")
    record["log2_flips"] = log2_flips

    # 6. the main path: the stereo transcode, chunk by chunk, both states carried
    def transcode(plain: bool = False, chunks: int = CHUNKS):
        est = dst = None
        units_out, pcm_out = [], []
        for k in range(chunks):
            units, est = _encode_batch_dev(upload(k), options, est, plain=plain)
            pcm, dst = _decode_batch_dev(units, dst, to_i16=True, plain=plain)
            units_out.append(units)
            pcm_out.append(pcm)
        return torch.cat(units_out, dim=1), torch.cat(pcm_out, dim=1)

    def timed(fn):
        return _timed(fn, dev)

    transcode(chunks=1)                                               # warm the tables
    torch.cuda.synchronize()
    kernels.reset_launches()
    wall, (units, pcm) = timed(transcode)
    launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0 and k not in PATHS]
    if missing:
        raise AssertionError(f"main path launched no {missing}: {launches}")
    if units.shape != (2, CHUNK * CHUNKS, 212) or pcm.shape != (2, CHUNK * CHUNKS, 512) or pcm.dtype != torch.int16:
        raise AssertionError(f"main path: units {tuple(units.shape)}, pcm {tuple(pcm.shape)} {pcm.dtype}")
    again_wall, (units2, pcm2) = timed(transcode)
    if _mismatch(units, units2)[0] or _mismatch(pcm, pcm2)[0]:
        raise AssertionError("main path: a second run on the same input gave other units or samples")
    plain_wall, (units_p, pcm_p) = timed(lambda: transcode(plain=True))
    mu, mp = _mismatch(units, units_p)[0], _mismatch(pcm, pcm_p)[0]
    if mu or mp:
        raise AssertionError(f"main path: {mu} unit bytes and {mp} int16 samples differ from the plain path")
    del units2, pcm2, units_p, pcm_p
    digest = _digest(units, pcm)
    print(f"main path: SHA-256 of the units {digest['units']}, of the int16 samples {digest['int16']}")
    short_total = (bitpack.unpack_frames(units.reshape(-1, 212)).block_modes != 0).sum(dim=0).tolist()
    if sum(short_total) == 0:
        raise AssertionError("main path: the encoder chose no short-mode frame")

    # the same stream through the public entry points, on a prefix of whole chunks
    flat16 = pcm16.reshape(2, -1)
    pre = 2 * CHUNK
    pub_units = encode_pcm(flat16[:, : pre * 512])
    pub_pcm = decode_units(pub_units, 2, to_i16=True)
    want_units = units[:, :pre].cpu().numpy()
    if not (np.array_equal(pub_units[0::2], want_units[0]) and np.array_equal(pub_units[1::2], want_units[1])):
        raise AssertionError("encode_pcm: units differ from the chunked run's prefix")
    if _mismatch(pub_pcm, pcm[:, :pre].reshape(2, -1))[0]:
        raise AssertionError("decode_units(encode_pcm(...)): samples differ from the chunked run's prefix")
    ragged = encode_pcm(source[:, : 700 * 512 + 77], chunk_frames=300)     # f32 input, a ragged tail
    if ragged.shape != (2 * 701, 212):
        raise AssertionError(f"encode_pcm on a ragged stream: units {ragged.shape}")

    got = pcm.reshape(2, -1).cpu().numpy().astype(np.float32) / 32768.0
    stream_psnr = [testing.psnr(source[ch], got[ch]) for ch in range(2)]

    def encode_only():
        est, out = None, None
        for k in range(CHUNKS):
            out, est = _encode_batch_dev(upload(k), options, est)
        return out

    def decode_only():
        dst, out = None, None
        for k in range(CHUNKS):
            out, dst = _decode_batch_dev(units[:, k * CHUNK:(k + 1) * CHUNK], dst, to_i16=True)
        return out

    upload_s = sorted(timed(lambda: upload(1))[0] for _ in range(3))[1]
    repeats = [timed(transcode)[0] for _ in range(3)]
    enc_repeats = [timed(encode_only)[0] for _ in range(3)]
    dec_repeats = [timed(decode_only)[0] for _ in range(3)]
    cf = 2 * CHUNK * CHUNKS
    fps = cf / wall
    print(f"main path: transcode of {CHUNKS} x {CHUNK} stereo frames (int16 -> units -> int16) in {wall:.4f} s = "
          f"{fps:.1f} channel-frames/s on {name} (second run {again_wall:.4f} s, repeats "
          f"{', '.join(f'{r:.4f}' for r in repeats)} s; plain versions {plain_wall:.4f} s); units and int16 equal "
          f"to the plain path and to a second run; launches {launches}")
    print(f"main path: encode alone {', '.join(f'{r:.4f}' for r in enc_repeats)} s = {cf / sorted(enc_repeats)[1]:.1f} "
          f"channel-frames/s; decode alone {', '.join(f'{r:.4f}' for r in dec_repeats)} s = "
          f"{cf / sorted(dec_repeats)[1]:.1f} channel-frames/s (median repeats); short frames per band {short_total}; "
          f"round-trip PSNR {stream_psnr[0]:.3f} / {stream_psnr[1]:.3f} dB (L / R); "
          f"upload of one chunk's int16 samples (pageable, {pcm16[:, :CHUNK].nbytes / 1e6:.1f} MB) {upload_s * 1e3:.3f} ms; "
          f"encode_pcm -> decode_units on {pre} frames equal to the chunked run")
    record["main_path"] = {"seconds": wall, "second_run_seconds": again_wall, "repeat_seconds": repeats,
                           "encode_repeat_seconds": enc_repeats, "decode_repeat_seconds": dec_repeats,
                           "plain_seconds": plain_wall, "channel_frames_per_s": fps, "launches": launches,
                           "short_frames_first_chunk": n_short, "short_frames": short_total,
                           "psnr_db": stream_psnr, "upload_one_chunk_seconds": upload_s, "digest": digest}
    for row in rows:
        row["launches_path"] = PATHS.get(row["name"], "phase 6")
        row["launches"] = launches[row["name"]] if row["launches_path"] == "phase 6" else None
        row["launches_encoder_checks"] = launches_p5[row["name"]]

    # 7. the decode stream of golden units through decode_units, and malformed units
    decode_units(stream[: 2 * 256], 2, to_i16=True)
    dwall, dpcm = timed(lambda: decode_units(stream, 2, to_i16=True))
    m, _ = _mismatch(dpcm, decode_units(stream, 2, to_i16=True, plain=True))
    if m or dpcm.shape != (2, CHUNK * DECODE_CHUNKS * 512):
        raise AssertionError(f"decode stream: {m} int16 samples differ from the plain path, shape {tuple(dpcm.shape)}")
    drepeats = [timed(lambda: decode_units(stream, 2, to_i16=True))[0] for _ in range(3)]
    print(f"decode stream: {DECODE_CHUNKS} x {CHUNK} stereo frames of golden units through decode_units in {dwall:.4f} s "
          f"(repeats {', '.join(f'{r:.4f}' for r in drepeats)} s); int16 equal to the plain path")
    record["decode_stream"] = {"seconds": dwall, "repeat_seconds": drepeats}
    del dpcm

    bad = np.random.default_rng(7).integers(0, 256, (64, 212)).astype(np.uint8)
    out_k = decode_units(bad, 1)
    out_p = decode_units(bad, 1, plain=True)
    torch.cuda.synchronize()
    m, _ = _mismatch(out_k, out_p)
    if m or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"random units: {m} words differ from the plain path or output not finite")
    print("random units: finite and equal to the plain path")

    # 8. where one chunk's time goes: device time by operation (torch.profiler),
    # the encode and the decode of the stream's first chunk apart
    prof_enc = _profile(lambda: _encode_batch_dev(upload(0), options, None))
    prof_dec = _profile(lambda: _decode_batch_dev(chunk, None, to_i16=True))
    walls = {"transcode": sorted(repeats)[1], "encode": sorted(enc_repeats)[1], "decode": sorted(dec_repeats)[1]}
    for part, prof in (("encode", prof_enc), ("decode", prof_dec)):
        chunk_ms = walls[part] / CHUNKS * 1e3                          # median repeat
        prof["host_wall_ms_unprofiled"] = chunk_ms
        print(f"profile of one stereo chunk, {part}: device busy {prof['device_ms']:.3f} ms of {chunk_ms:.3f} ms host wall "
              f"(unprofiled) = idle share {1 - prof['device_ms'] / chunk_ms:.3f}; {prof['device_launches']} device launches; "
              "top: " + "; ".join(f"{o['name'][:40]} x{o['count']} {o['self_device_ms']:.3f} ms" for o in prof["ops"][:8]))
        print(f"host time of that {part} under the profiler (self CPU ms, inflated by it): "
              + "; ".join(f"{o['name'][:32]} x{o['count']} {o['self_cpu_ms']:.2f}" for o in prof["host_ops_profiled"][:10]))
        print(f"hand kernels in that {part} (device ms, all launches): "
              + "; ".join(f"{h['name']} x{h['count']} {h['device_ms']:.4f}" for h in prof["hand_kernels"]))
    busy = prof_enc["device_ms"] + prof_dec["device_ms"]
    chunk_ms = walls["transcode"] / CHUNKS * 1e3
    print(f"profile of one stereo chunk, transcode: device busy {busy:.3f} ms of {chunk_ms:.3f} ms host wall "
          f"(unprofiled) = idle share {1 - busy / chunk_ms:.3f}; "
          f"{prof_enc['device_launches'] + prof_dec['device_launches']} device launches")
    record["profile_one_chunk"] = {"encode": prof_enc, "decode": prof_dec, "device_ms": busy,
                                   "host_wall_ms_unprofiled": chunk_ms}

    # 9. the file layer on the card: phase 6's stream as a WAV file
    record["files"] = files_phase(pcm16, units, pcm, options, smi, walls, os.path.join(fixtures, "golden.aea"))
    for row in rows:
        row["launches_files"] = record["files"]["launches"][row["name"]]

    # 10. the sharded paths, the fast decoder, the streams and the corpus
    t10 = time.perf_counter()
    work = os.path.join("build", "chip_smoke_files")
    record["phase10"] = sharded_phase(pcm16, units, pcm, options, walls, work, golden_units, golden, dev)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")
    for row in rows:
        row["launches_sharded"] = record["phase10"]["launches_sharded"][row["name"]]

    # 11. the exact engine
    t11 = time.perf_counter()
    record["phase11"] = exact_phase(pcm16, units, options, fixtures, golden_units, golden, dev, check, rows,
                                     conv_rate)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")

    # 12. the gold surface on the card, and on_progress
    record["phase12"] = gold_surface_phase(pcm16, units, pcm, options, dev, smi)
    for row in rows:
        row["launches_gold_surface"] = record["phase12"]["launches"][row["name"]]

    # 13. the JAX package's calling contract on the card, on phase 9's files
    record["phase13"] = contract_phase(pcm16, units, pcm, options, work, dev, smi)
    shutil.rmtree(work)
    for row in rows:
        row["launches_contract"] = record["phase13"]["launches"][row["name"]]

    # 14. the reference allocator's transcode at full width, and its CLI flag
    record["phase14"] = reference_phase(pcm16, dev, smi)
    for row in rows:
        row["launches_reference"] = record["phase14"]["launches"][row["name"]]
        if row["launches_path"] == "phase 14":
            row["launches"] = row["launches_reference"]

    # 15. the measurement harness on the card
    t15 = time.perf_counter()
    record["phase15"] = harness_phase(dev)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    record["kernels"] = rows
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    with open(args.record, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shapes"} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
