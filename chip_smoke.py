#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port builds, encodes and decodes on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  python3 chip_smoke.py [--record PATH]

Phases (each raises on failure; nothing is caught):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: compiles every kernel (K1 IMDCT at sizes 64/256/512, K2 QMF
     taps, K3 field read, K4 allocation sweep) from carta1_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the first stereo 8192-frame chunk of the transcode gives it,
     and on edge inputs (batches around a block's tile, small widths, +0,
     -0, denormals, overflow to inf, lone samples at a row's ends; for K4
     invalid candidates, every BFU abandoned, a budget met exactly, zero
     costs): 0 differing words allowed; kernel, plain and library-call
     times, the kernel's bound, and the time of an empty launch;
  4. the golden fixture decoded to int16 on the card equals
     tests/fixtures/golden_decode.npz exactly;
  5. the encoder on the card against tests/fixtures/torch_encode_expect.npz
     (the gold engine on six signal classes): block modes and scale
     factors equal gold's with the reference allocator, round-trip PSNR at
     least gold's with the default one, the bit budget on every frame, the
     share of fields equal to the CPU run, and what an f32 log2 would make
     of amplitudes around every scale-factor table value;
  6. the main path: a stereo int16 stream of 4 x 8192 frames per channel,
     chunk by chunk through encode -> 212-byte units on the card -> decode
     -> int16, both stream states carried; launch counters reset just
     before and read just after; units and int16 must equal the same run
     with the plain versions and a second run, every kernel must have
     launched; then encode_pcm -> decode_units on a prefix, and the times
     of the transcode, of encode alone and of decode alone;
  7. the decode stream of golden units (2 x 8192 stereo frames through
     decode_units) against the plain path, and 64 units of random bytes;
  8. torch.profiler over one chunk's encode and one chunk's decode: device
     time by operation, launches, the hand kernels' device time;
  9. the file layer: phase 6's stream as a WAV through encode_file and
     decode_file (units and int16 equal to phase 6's; launch counters reset
     just before and read just after, every kernel must have launched), a
     killed and resumed encode and decode (byte-identical), the CLI's
     --encode/--decode (byte-identical) and --json (equal to the CPU's dump),
     encode_clips against encode_pcm per clip (at most 1% of bytes differ),
     and the file walls (a first run and three repeats) and their split
     beside phase 6's in-memory walls.
     Its files go under build/ and are deleted at the end.

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

CHUNK = 8192
CHUNKS = 4
DECODE_CHUNKS = 2          # the decode-only stream of golden units
# NVIDIA H100 SXM data sheet peaks (dense, 700 W): HBM3 bytes/s, and FP64
# outside the tensor cores.  The sheet's 34 TFLOP/s counts an FMA as two
# operations; the exact kernels may not fuse a multiply with an add, so the
# rate they can reach is half of it.
PEAK_BYTES_S = 3.35e12
PEAK_F64_S = 17e12


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F64_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    missing = [k for k, v in launches.items() if v == 0]
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
    shutil.rmtree(work)
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=os.path.join("build", "chip_smoke.json"),
                        help="where to write the full JSON record")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the GPU", file=sys.stderr)
        return 2

    from carta1_tpu_torch import EncoderOptions, decode_units, encode_frames, encode_pcm, kernels, testing
    from carta1_tpu_torch import constants as C
    from carta1_tpu_torch.constants import QMF_EVEN, QMF_ODD
    from carta1_tpu_torch.io.aea import read_aea
    from carta1_tpu_torch.ops import bitalloc, bitalloc_kernels, bitpack, bitpack_kernels, imdct_kernels, qmf_kernels
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

    # 2. build (all nvcc runs at once)
    build_s = kernels.build()
    print(f"build: {build_s:.2f} s for {', '.join(kernels.LIBRARIES)}")
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

    def check(kname, cases, plain_fn, kernel_fn, nbytes, ops, reps, library=None, edge_cases=()):
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
        bound, by = _bound_ms(nbytes, ops)
        src, replaces = kernels.KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": f"carta1_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms, "host_ms": host_ms,
            "shapes": [[list(t.shape) for t in a if isinstance(t, torch.Tensor)] for a in cases],
        })
        print(f"{kname}: 0 words differ from the plain version ({len(edge_cases)} edge inputs too); kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms {bound:.4f} ({by}) "
              f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)}")

    empty_ms, empty_host_ms = kernels.time_ms(lambda: kernels.empty_launch(dev), 200)
    print(f"empty launch through ctypes: {empty_ms:.4f} ms on the device, {empty_host_ms:.4f} ms of host time, "
          "each, back to back on one stream")
    record["empty_launch_ms"] = {"device": empty_ms, "host": empty_host_ms}

    for size, batch in ((64, n64), (256, 2 * frames), (512, frames)):
        x = _spectra(rng, batch, size // 2, dev)
        edges = [(torch.from_numpy(testing.imdct_edge_spectra(size, b, sd)).to(dev), size)
                 for b, sd in testing.edge_cases(imdct_kernels.TILE[size])]
        n = size // 4
        ops = batch * (12 * n + 10 * (n // 2) * (n.bit_length() - 1))
        table_bytes = (size // 2) * 8 + 2 * (n - 1) * 8
        check(f"imdct_exact_{size}", [(x, size)], imdct_kernels.imdct_mid_plain,
              imdct_kernels.imdct_mid, x.numel() * 8 + table_bytes, ops, reps=50, edge_cases=edges)

    works = [(torch.from_numpy(rng.standard_normal((frames, 46 + 2 * s)).astype(np.float32)).to(dev),)
             for s in (128, 256)]
    print("imdct_exact: library_ms null -- no single PyTorch call computes these bits "
          "(an FFT-based IMDCT rounds at other points)")
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

    # K4 on the candidates both allocators make of that chunk
    bfu, sf, _, _ = analysis_step(int16_to_float(upload(0)), encoder_init_state(dev, 2), options.band_thresholds)
    bfu, sf = bfu.reshape(-1, C.NUM_BFUS, C.MAX_BFU_SIZE), sf.reshape(-1, C.NUM_BFUS)
    cands_rdo = bitalloc.rdo_candidates(bfu, sf, options.allocation_bias).contiguous()
    cands_ref = bitalloc.reference_candidates(sf, options.allocation_bias).contiguous()
    del bfu
    print("alloc_sweep: library_ms null -- no PyTorch call computes a budgeted sequential sweep")
    check("alloc_sweep", [(cands_rdo,)], bitalloc_kernels.alloc_sweep_plain, bitalloc_kernels.alloc_sweep,
          cands_rdo.numel() * 4 + frames * C.NUM_BFUS * 4, 0, reps=50,
          edge_cases=[(cands_ref,)] + [(torch.from_numpy(c).to(dev),)
                                       for _, c in testing.sweep_edge_cases(bitalloc_kernels.BLOCK_FRAMES)])
    used = (bitalloc_kernels.alloc_sweep(cands_rdo) > 0).float().mean().item()
    print(f"alloc_sweep: main-path candidates [{cands_rdo.shape[0]}, {cands_rdo.shape[1]}], "
          f"{(cands_rdo & 1).float().mean().item():.3f} valid, {used:.3f} of BFUs given bits")
    del cands_rdo, cands_ref

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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    transcode(chunks=1)                                               # warm the tables
    torch.cuda.synchronize()
    kernels.reset_launches()
    wall, (units, pcm) = timed(transcode)
    launches = dict(kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
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
                           "psnr_db": stream_psnr, "upload_one_chunk_seconds": upload_s}
    for row in rows:
        row["launches"] = launches[row["name"]]

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
    cuda = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    hand_names = ("imdct", "qmf_taps", "read_fields", "alloc_sweep")

    def profile(fn) -> dict:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device-side rows (kernels, copies) count each device interval once;
        # host-side rows attribute that time to the operation that launched it
        dev_rows = sorted(([e.key, e.count, e.self_device_time_total / 1e3] for e in events
                           if e.device_type == cuda), key=lambda r: -r[2])
        ops = sorted(([e.key, e.count, e.self_device_time_total / 1e3] for e in events
                      if e.device_type != cuda and e.self_device_time_total > 0), key=lambda o: -o[2])
        host = sorted(([e.key, e.count, e.self_cpu_time_total / 1e3] for e in events if e.device_type != cuda),
                      key=lambda o: -o[2])
        return {"device_ms": sum(r[2] for r in dev_rows), "device_launches": sum(r[1] for r in dev_rows),
                "host_ops_profiled": [{"name": k, "count": c, "self_cpu_ms": ms} for k, c, ms in host[:25]],
                "hand_kernels": [{"name": k.replace("(anonymous namespace)::", "").split("(")[0], "count": c,
                                  "device_ms": ms} for k, c, ms in dev_rows if any(w in k for w in hand_names)],
                "ops": [{"name": k, "count": c, "self_device_ms": ms} for k, c, ms in ops[:30]],
                "device_rows": dev_rows[:30]}

    prof_enc = profile(lambda: _encode_batch_dev(upload(0), options, None))
    prof_dec = profile(lambda: _decode_batch_dev(chunk, None, to_i16=True))
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
