"""What every harness module and `chip_smoke.py` measure with.

- `smi` / `device_record`: the card's name and power limit as `nvidia-smi`
  reads them, so every number goes out beside the card that made it; on
  the CPU the record says `"platform": "cpu"`.
- `sync` / `timed`: a host clock around work that ends in
  `torch.cuda.synchronize()` of every card it ran on (one device, or a
  mesh's tuple of them): the step's wall, since PyTorch returns before the
  card is done and a clock without the synchronise reads the enqueue.
- `clocked`: one call on `timed`'s clock and, on the card, between two
  CUDA events on its stream.  Callers repeat it; `spread` reports the
  median, min and max of the repeats, never the best.
- `profile` / `busy`: `torch.profiler` over one window: device busy ms,
  device launches, the top device rows and the hand kernels' times; the
  idle share is 1 - busy / the unprofiled wall of the same work.

Device metrics (event times, busy, idle share) exist only on the card: on
the CPU these functions give None for them, never a host number.
"""

from __future__ import annotations

import platform
import statistics
import subprocess
import time

import torch

# substrings of the hand kernels' symbol names (csrc/*.cu)
HAND_NAMES = ("imdct", "qmf_taps", "read_fields", "alloc_rdo", "alloc_reference", "alloc_heap", "fftjs")


def smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(dev: torch.device) -> dict:
    """{"platform", "name", "power_limit", "count"} of the device a
    measurement ran on: for a card from `nvidia-smi`, for the CPU the
    machine's processor with no power limit."""
    if dev.type == "cuda":
        name, power = (s.strip() for s in smi().rsplit(",", 1))
        return {"platform": "gpu", "name": name, "power_limit": power, "count": torch.cuda.device_count()}
    return {"platform": "cpu", "name": platform.processor() or platform.machine(), "power_limit": None, "count": 1}


def sync(devices) -> None:
    """Wait for every card among `devices`: one device, or a mesh's tuple."""
    for d in {devices} if isinstance(devices, torch.device) else set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed(fn, devices):
    """(host seconds, fn()) with the cards among `devices` synchronised
    before and after."""
    sync(devices)
    t0 = time.perf_counter()
    out = fn()
    sync(devices)
    return time.perf_counter() - t0, out


def clocked(fn, dev: torch.device) -> tuple[float, float | None]:
    """(host seconds, CUDA-event ms) of one call of fn(): `timed`'s clock
    and, on the card, two events around the call on the current stream
    (None on the CPU).  The events read the card's time from the first
    launch to the last, idle gaps between launches included (the
    device-side wall, not its busy time)."""
    if dev.type != "cuda":
        return timed(fn, dev)[0], None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        fn()
        end.record()
    return timed(run, dev)[0], start.elapsed_time(end)


def spread(xs: list[float] | None) -> dict | None:
    """Median, min and max of a list of repeats, with the repeats."""
    if xs is None:
        return None
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "n": len(xs), "runs": list(xs)}


def profile(fn) -> dict:
    """Where fn()'s time goes on the card, by torch.profiler: device busy ms,
    device launches, the top device rows and the hand kernels' times."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
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
                              "device_ms": ms} for k, c, ms in dev_rows if any(w in k for w in HAND_NAMES)],
            "ops": [{"name": k, "count": c, "self_device_ms": ms} for k, c, ms in ops[:30]],
            "device_rows": dev_rows[:30]}


def busy(fn, wall_s: float, dev: torch.device, calls: int = 1) -> dict:
    """One window of fn() under `profile`, beside `wall_s`, the unprofiled
    host wall of the same work: device busy ms, launches, the top device
    rows and the hand kernels, each per call when fn() makes `calls` calls,
    and the idle share of the window.  All None on the CPU."""
    if dev.type != "cuda":
        return {"device_busy_ms": None, "device_launches": None, "idle_share": None, "top": None, "hand_kernels": None}
    prof = profile(fn)
    return {"device_busy_ms": prof["device_ms"] / calls, "device_launches": prof["device_launches"] / calls,
            "idle_share": 1.0 - prof["device_ms"] / (wall_s * 1e3),
            "top": [{"name": o["name"][:60], "count": o["count"] / calls, "device_ms": o["self_device_ms"] / calls}
                    for o in prof["ops"][:8]],
            "hand_kernels": [{**h, "count": h["count"] / calls, "device_ms": h["device_ms"] / calls}
                             for h in prof["hand_kernels"]]}
