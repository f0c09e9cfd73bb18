"""Bounded memory over an hour-long stream: the port of `tools/stream_stress.py`.

Synthesizes a stereo 16-bit WAV of `--minutes` (default 60) in 10 s slabs,
then runs it WAV -> AEA -> WAV through `encode_file` / `decode_file` with
checkpoints, on the card unless `--device cpu`.  Reports the process's peak
RSS (read after every chunk: `RssPeak`), its growth past the footprint
after a warm run of three chunks (the CUDA context, the kernels, the
tables) and its shared part (file-backed pages, where the kernel reports
them), the card's peak
allocated memory over the two streams (`torch.cuda.max_memory_allocated`
after `reset_peak_memory_stats`; null on the CPU) and channel-frames/s
each way.  It fails, as the JAX script does,
when that growth reaches 512 MB: the host pipeline must stream, not hold
the file.

    python -m carta1_tpu_torch.harness.stream_stress [--minutes 60] [--device cpu]

Output: one JSON line with `"device"`, and `"reduced"` when `--minutes` is
not 60.  The files go under `--workdir` (default
`build/harness/stream_stress` in the checkout) and are deleted at the end
(the directory too, when nothing else is in it) unless `run(keep=True)`.  Peak RSS
is the whole process's, so run the module in a process of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.harness.common import device_record
from carta1_tpu_torch.io.streams import WavStreamWriter
from carta1_tpu_torch.kernels import BUILD_DIR
from carta1_tpu_torch.processor import DEFAULT_CHUNK_FRAMES, decode_file, encode_file

WORKDIR = str(BUILD_DIR.parent / "harness" / "stream_stress")
MINUTES = 60.0
GROWTH_BUDGET_MB = 512.0
SLAB = 441000                       # samples per channel per slab: 10 s


def rss_mb() -> dict[str, float]:
    """The process's resident set now, MB, from /proc/self/statm: "total"
    and "shared" (file-backed and shared pages, which would hold a mapped
    input's; 0 where the kernel does not report them)."""
    with open("/proc/self/statm") as f:
        fields = f.read().split()
    page_mb = os.sysconf("SC_PAGE_SIZE") / 2**20
    return {"total": int(fields[1]) * page_mb, "shared": int(fields[2]) * page_mb}


class RssPeak:
    """The largest resident set read so far: called as `on_progress` after
    every chunk, and directly between the phases.  A sampled peak, because
    getrusage's ru_maxrss (the JAX script's) carries the parent's peak into
    a process started from another on Linux, and VmHWM is not reported
    everywhere."""

    def __init__(self):
        self.peak = {"total": 0.0, "shared": 0.0}

    def __call__(self, done: int = 0, total: int = 0) -> dict[str, float]:
        now = rss_mb()
        self.peak = {k: max(v, now[k]) for k, v in self.peak.items()}
        return now


def synth_wav(path: str, minutes: float) -> int:
    """Write a stereo 16-bit WAV of `minutes` in 10 s slabs (bounded
    memory); returns its samples per channel."""
    n = int(minutes * 60 * C.SAMPLE_RATE)
    w = WavStreamWriter(path, channels=2)
    written = 0
    rng = np.random.default_rng(7)
    while written < n:
        m = min(SLAB, n - written)
        t = np.arange(written, written + m) / C.SAMPLE_RATE
        sig = np.stack([
            0.35 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(m),
            0.35 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(m),
        ]).astype(np.float32)
        w.append(np.clip(sig, -1, 1))
        written += m
    w.close()
    return n


def run(minutes: float = MINUTES, chunk_frames: int = DEFAULT_CHUNK_FRAMES, engine: str = "tpu", device=None,
        workdir: str = WORKDIR, keep: bool = False) -> dict:
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    path = {k: os.path.join(workdir, k) for k in ("in.wav", "out.aea", "round.wav", "warm.wav", "warm.aea",
                                                  "warm.out.wav", "enc.ck.npz", "dec.ck.npz")}
    try:
        t0 = time.perf_counter()
        samples = synth_wav(path["in.wav"], minutes)
        synth_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path["in.wav"]) / 2**20
        rss_synth = rss_mb()

        # a warm run first: the CUDA context, the kernels and the tables are
        # set-up, not streaming growth
        synth_wav(path["warm.wav"], chunk_frames * 3 * C.SAMPLES_PER_FRAME / C.SAMPLE_RATE / 60)
        encode_file(path["warm.wav"], path["warm.aea"], None, engine, chunk_frames=chunk_frames, device=dev)
        decode_file(path["warm.aea"], path["warm.out.wav"], engine, chunk_frames=chunk_frames, device=dev)
        rss_warm = rss_mb()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        peaks = {"encode": RssPeak(), "decode": RssPeak()}
        t0 = time.perf_counter()
        enc = encode_file(path["in.wav"], path["out.aea"], None, engine, chunk_frames=chunk_frames,
                          on_progress=peaks["encode"], checkpoint=path["enc.ck.npz"], device=dev)
        enc_s = time.perf_counter() - t0
        peaks["encode"]()
        t0 = time.perf_counter()
        dec = decode_file(path["out.aea"], path["round.wav"], engine, chunk_frames=chunk_frames,
                          on_progress=peaks["decode"], checkpoint=path["dec.ck.npz"], device=dev)
        dec_s = time.perf_counter() - t0
        peaks["decode"]()
        peak = max(p.peak["total"] for p in peaks.values())
        growth = peak - rss_warm["total"]
        record = {
            "minutes": minutes, "engine": engine, "chunk_frames": chunk_frames,
            "reduced": None if minutes == MINUTES else f"{minutes} of the script's {MINUTES} minutes",
            "samples_per_channel": samples, "wav_mb": size_mb, "synth_s": synth_s,
            "encode": {"units": enc.frames, "seconds": enc_s, "channel_frames_per_s": enc.frames / enc_s,
                       "realtime": enc.duration / enc_s, "peak_rss_mb": peaks["encode"].peak},
            "decode": {"units": dec.frames, "seconds": dec_s, "channel_frames_per_s": dec.frames / dec_s,
                       "realtime": dec.duration / dec_s, "peak_rss_mb": peaks["decode"].peak},
            "rss_mb": {"after_synthesis": rss_synth, "after_warm_run": rss_warm, "peak": peak,
                       "growth_past_warm": growth, "growth_budget": GROWTH_BUDGET_MB,
                       "sampled": "after every chunk of each stream (statm)"},
            "device_peak_allocated_mb": torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else None,
            "device": device_record(dev),
        }
        if growth >= GROWTH_BUDGET_MB:
            raise AssertionError(f"stream_stress: RSS grew {growth:.0f} MB past the warm run over a {size_mb:.0f} MB "
                                 f"WAV (budget {GROWTH_BUDGET_MB:.0f} MB): {record}")
        return record
    finally:
        if not keep:
            for f in path.values():
                if os.path.exists(f):
                    os.remove(f)
            if not os.listdir(workdir):
                os.rmdir(workdir)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--minutes", type=float, default=MINUTES)
    p.add_argument("--chunk-frames", type=int, default=DEFAULT_CHUNK_FRAMES)
    p.add_argument("--engine", default="tpu")
    p.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    p.add_argument("--workdir", default=WORKDIR)
    a = p.parse_args(argv)
    record = run(a.minutes, a.chunk_frames, a.engine, a.device, a.workdir)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
