"""Measure the instruction rates that bound the exact kernels on this card.

    python -m carta1_tpu_torch.probe_rates [--scaling]

Builds `csrc/probe_rates.cu` and times seven loops of independent chains
with CUDA events: unfused f64 adds, f64 -> f32 -> f64 round trips, both
mixed, the rounding alone, the widening alone, and f64 multiplies by a
register and by a kernel parameter (the way K2 takes its taps and K1 its
first twiddles).  Prints operations per
second for each, the card's name and power limit, and whether the mix
takes the sum of its parts (one pipe) or the larger of them (two).  K1
rounds and widens every value after every FFT stage and K2 widens every
sample it reads, so these rates, not the data sheet's FLOP/s, are what
their times are read against.  With `--scaling` it also times K1 and K2
over a range of batches, which separates a kernel's fixed cost (launch,
ramp) from its cost per row.  `chip_smoke.py` calls `measure` for the
conversion rate in K1's and K6's bounds.  Needs the card; not part of the
decode path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from carta1_tpu_torch import kernels

MODES = ("dadd", "round+widen", "dadd & round+widen", "round f64->f32", "widen f32->f64",
         "dmul by a register", "dmul by a kernel parameter")
BLOCKS, THREADS, CHAINS, ITERS = 132 * 8, 256, 8, 4096


def scaling() -> None:
    """Device time of K1 (each size) and K2 (s = 128, 256) over batches."""
    from carta1_tpu_torch.ops import imdct_kernels, qmf_kernels

    gen = torch.Generator(device="cuda").manual_seed(0)
    for size in imdct_kernels.SIZES:
        for batch in (1056, 4096, 8192, 16384, 32768, 65536, 131072):
            x = torch.randn((batch, size // 2), device="cuda", generator=gen)
            ms, _ = kernels.time_ms(lambda: imdct_kernels.imdct_mid(x, size), 50)
            print(f"imdct_exact_{size} batch {batch}: {ms:.4f} ms")
    for s in (128, 256):
        for batch in (2048, 8192, 16384, 32768, 65536):
            work = torch.randn((batch, 46 + 2 * s), device="cuda", generator=gen)
            ms, _ = kernels.time_ms(lambda: qmf_kernels.qmf_taps(work), 50)
            print(f"qmf_taps s {s} batch {batch}: {ms:.4f} ms")


PER_LAUNCH = BLOCKS * THREADS * CHAINS * ITERS          # of each operation a mode names, per launch


def measure(names=MODES) -> dict[str, float]:
    """ms per launch of each named loop on the current card (one warm-up
    launch, then the mean of three)."""
    lib = kernels.library("probe_rates")
    fn = lib.carta1_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(BLOCKS * THREADS, dtype=torch.float64, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    times = {}
    for name in names:
        mode = MODES.index(name)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for timed in (False, True):
            start.record()
            for _ in range(3 if timed else 1):
                kernels.check(lib, fn(kernels.ptr(out), mode, BLOCKS, ITERS, stream), "probe_rates")
            end.record()
            torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 3
    return times


def conversion_rate(ms_round_trip: float) -> float:
    """Conversions per second (a rounding and a widening count as two) of
    the round-trip loop that took `ms_round_trip` per launch."""
    return 2 * PER_LAUNCH / (ms_round_trip * 1e-3)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scaling", action="store_true", help="also time K1 and K2 over batch sizes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_rates: CUDA is not available; this script needs the GPU", file=sys.stderr)
        return 2
    times = measure()
    for name in MODES:
        print(f"{name}: {times[name]:.4f} ms per launch, {PER_LAUNCH / times[name] / 1e9:.3f} T/s of each operation named")
    print(f"conversions (rounding and widening counted apart): {conversion_rate(times['round+widen']) / 1e12:.3f} T/s")
    parts = times["dadd"] + times["round+widen"]
    larger = max(times["dadd"], times["round+widen"])
    mix = times["dadd & round+widen"]
    print(f"mix {mix:.4f} ms against sum of parts {parts:.4f} ms and larger part {larger:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "per_launch": PER_LAUNCH, "ms": times}))
    if args.scaling:
        scaling()
    return 0


if __name__ == "__main__":
    sys.exit(main())
