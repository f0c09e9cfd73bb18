#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port builds and decodes on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  python3 chip_smoke.py [--record PATH]

Phases (each raises on failure; nothing is caught):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: compiles every kernel of the decode path (K1 IMDCT at sizes
     64/256/512, K2 QMF taps, K3 field read) from carta1_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes one stereo 8192-frame chunk gives it, and K1 and K2 on edge
     inputs too (batches around a block's tile, small widths, +0, -0,
     denormals, overflow to inf, lone samples at a row's ends): 0 differing
     words allowed; kernel, plain and library-call times, the kernel's
     bound, and the time of an empty launch through the same route;
  4. the golden fixture decoded to int16 on the card equals
     tests/fixtures/golden_decode.npz exactly;
  5. the main path: a stereo stream of 4 x 8192 frames per channel through
     decode_units on the card, launch counters reset just before and read
     just after; its int16 output must equal the same call with the plain
     versions, and every kernel must have launched;
  6. 64 units of random bytes decode to finite PCM equal to the plain path;
  7. a torch.profiler pass over one stereo chunk: device time by operation.

The last lines are a JSON `kernels` line, the card's name and power limit,
and the result line.  The full record (every timing, the profile) goes to
--record, by default build/chip_smoke.json.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CHUNK = 8192
CHUNKS = 4
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
    """4 x 8192 frames per channel, tiled from the golden units with
    different offsets for L and R (both keep the fixture's short frames)."""
    n = CHUNK * CHUNKS
    reps = -(-(n + 41) // units.shape[0])
    tiled = np.tile(units, (reps, 1))
    left, right = tiled[:n], tiled[41:41 + n]
    out = np.empty((2 * n, units.shape[1]), np.uint8)
    out[0::2], out[1::2] = left, right
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=os.path.join("build", "chip_smoke.json"),
                        help="where to write the full JSON record")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the GPU", file=sys.stderr)
        return 2

    from carta1_tpu_torch import decode_units, kernels, testing
    from carta1_tpu_torch.constants import QMF_EVEN, QMF_ODD
    from carta1_tpu_torch.io.aea import read_aea
    from carta1_tpu_torch.ops import bitpack, bitpack_kernels, imdct_kernels, qmf_kernels

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

    # main-path inputs: the first chunk of the stereo stream
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
    _, golden_units = read_aea(os.path.join(fixtures, "golden.aea"))
    stream = _stereo_stream(golden_units)
    chunk = torch.from_numpy(
        np.ascontiguousarray(np.stack([stream[0::2][:CHUNK], stream[1::2][:CHUNK]]))
    ).to(dev)                                                            # [2, 8192, 212]
    modes = bitpack.unpack_frames(chunk.reshape(-1, 212)).block_modes != 0
    n_short = modes.sum(dim=0).tolist()
    n64 = 4 * n_short[0] + 4 * n_short[1] + 8 * n_short[2]
    if n64 == 0:
        raise AssertionError("the smoke stream has no short-mode frames")
    frames = 2 * CHUNK

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

    # 4. golden fixture, int16-exact on the card
    golden = np.load(os.path.join(fixtures, "golden_decode.npz"))["int16"]
    got = decode_units(golden_units, 1, to_i16=True).cpu().numpy().reshape(-1)
    if not np.array_equal(got, golden):
        raise AssertionError(f"golden int16 differs in {(got != golden).sum()} samples")
    print(f"golden fixture: {golden.size} int16 samples equal")

    # 5. the main path: 4 x 8192-frame stereo stream, state carried across chunks
    decode_units(stream[: 2 * 256], 2, to_i16=True)                   # warm the tables
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pcm = decode_units(stream, 2, to_i16=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    plain = decode_units(stream, 2, to_i16=True, plain=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    m, _ = _mismatch(pcm, plain)
    if m or pcm.shape != (2, CHUNK * CHUNKS * 512):
        raise AssertionError(f"main path: {m} int16 samples differ from the plain path, shape {tuple(pcm.shape)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}: {launches}")
    repeats = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode_units(stream, 2, to_i16=True)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
    fps = 2 * CHUNK * CHUNKS / wall
    print(f"main path: {CHUNKS} x {CHUNK} stereo frames in {wall:.4f} s = {fps:.1f} channel-frames/s "
          f"on {name} (repeats {', '.join(f'{r:.4f}' for r in repeats)} s; plain versions {plain_wall:.4f} s); "
          f"int16 equal to the plain path; launches {launches}")
    record["main_path"] = {"seconds": wall, "repeat_seconds": repeats, "plain_seconds": plain_wall,
                           "channel_frames_per_s": fps, "launches": launches,
                           "short_frames_first_chunk": n_short}
    for row in rows:
        row["launches"] = launches[row["name"]]

    # 6. malformed units: random bytes
    bad = np.random.default_rng(7).integers(0, 256, (64, 212)).astype(np.uint8)
    out_k = decode_units(bad, 1)
    out_p = decode_units(bad, 1, plain=True)
    torch.cuda.synchronize()
    m, _ = _mismatch(out_k, out_p)
    if m or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"random units: {m} words differ from the plain path or output not finite")
    print("random units: finite and equal to the plain path")

    # 7. where one chunk's time goes: device time by operation (torch.profiler)
    one_chunk = stream[: 2 * CHUNK]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decode_units(one_chunk, 2, to_i16=True)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    # device-side rows (kernels, copies) count each device interval once;
    # host-side rows attribute that time to the operation that launched it
    device_ms = sum(e.self_device_time_total for e in events if e.device_type == cuda) / 1e3
    device_launches = sum(e.count for e in events if e.device_type == cuda)
    ops = sorted(((e.key, e.count, e.self_device_time_total / 1e3) for e in events
                  if e.device_type != cuda and e.self_device_time_total > 0), key=lambda o: -o[2])
    chunk_ms = sorted(repeats)[1] / CHUNKS * 1e3                       # median repeat
    print(f"profile of one stereo chunk: device busy {device_ms:.3f} ms of {chunk_ms:.3f} ms host wall "
          f"(unprofiled) = idle share {1 - device_ms / chunk_ms:.3f}; {device_launches} device launches; top: "
          + "; ".join(f"{k[:40]} x{c} {ms:.3f} ms" for k, c, ms in ops[:6]))
    hand = [(e.key, e.count, e.self_device_time_total / 1e3) for e in events
            if e.device_type == cuda and any(w in e.key for w in ("imdct", "qmf_taps", "read_fields"))]
    print("hand kernels in that chunk (device ms, all launches): "
          + "; ".join(f"{k.replace('(anonymous namespace)::', '').split('(')[0]} x{c} {ms:.4f}" for k, c, ms in hand))
    record["profile_one_chunk"] = {
        "device_ms": device_ms, "host_wall_ms_unprofiled": chunk_ms, "device_launches": device_launches,
        "hand_kernels": [{"name": k, "count": c, "device_ms": ms} for k, c, ms in hand],
        "ops": [{"name": k, "count": c, "self_device_ms": ms} for k, c, ms in ops[:30]],
        "device_rows": sorted(([e.key, e.count, e.self_device_time_total / 1e3] for e in events
                               if e.device_type == cuda), key=lambda r: -r[2])[:30],
    }

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
