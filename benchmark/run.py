"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`), from the root of a checkout, on a
machine with the card(s) the cell asks for.  A cell of `chips` N runs on
cuda:0 .. cuda:N-1; its traffic is made, and its calls take and return
their data, on the first.

The cell's traffic names its entry, a file `benchmark/ops/<op>.py`
(`spec.op`): what the calls read, made at set-up from the traffic's PCM,
and the chunk step over the cell's cards.  Its `FAMILY` names the
end-to-end metrics.

Set-up (counted in `setup_s`, from the start of this script to the first
timed call): the package's kernels found in the checkout's build
directory (built there by the first run), the cell's traffic made on the
card from the seed, what the calls read made from it (for a decode cell
the units of those tracks, encoded by the configuration's engine), then
one whole track's calls (every shape the window uses) run once.

The window is a closed loop over the chunk step: each call is one chunk
of all rows, ends in a synchronise of every card of the cell (the caller
takes its result), carries the rows' stream states through a track's
chunks and starts the next batch of tracks from the zero state.  It runs
whole calls until `--seconds` have passed; the rate is all the
channel-frames of all its calls over all its time, the tail is the 95th
percentile of all its calls' times.  With `--trace 1` a stretch of whole calls after the window
runs under `torch.profiler`, and the cell's per-layer metrics are read
from it instead; the device's busy and idle are the means over the
cell's cards (`trace`).  `memory_peak_bytes` is the fullest card's peak.

After the window (and the memory peak) the outputs of calls drawn from
the seed are held against the plain reference (`judge`), and so are a
decode cell's input units where its limits file names a judge for them
(`units`); each number compared and its limit are the last lines on
standard error and the last key of the result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cache a run may write stays at a fixed place inside the checkout
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "benchmark" / _dir)

import torch  # noqa: E402

from benchmark import judge, program, spec, stats, trace, traffic_gen  # noqa: E402
from benchmark.reference import bitstream  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "carta1_tpu")    # top-level module names, compared whole
SAMPLED_PER_CHUNK = 2                                   # calls judged per chunk of a track
MAX_HORIZON = 120                                       # sampled calls are drawn from the first ones


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def cards(n: int) -> tuple[torch.device, ...]:
    """The devices of a cell of `chips` n: cuda:0 .. cuda:n-1."""
    return tuple(torch.device("cuda", i) for i in range(n))


def card(device: torch.device) -> dict:
    """The device record of the result: name, count, power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        power = out[device.index or 0] if out else None
    except (OSError, subprocess.SubprocessError):
        power = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "power_limit": power}


def sampled_calls(seed: int, chunks: int, horizon: int) -> set[int]:
    """Calls whose outputs are judged: SAMPLED_PER_CHUNK of each chunk
    position, drawn from the seed among calls chunks .. horizon - 1."""
    rng = random.Random(seed)
    out = set()
    for k in range(chunks):
        pool = [i for i in range(chunks, max(horizon, chunks + SAMPLED_PER_CHUNK * chunks)) if i % chunks == k]
        out.update(rng.sample(pool, SAMPLED_PER_CHUNK))
    return out


def short_band_frames(units: torch.Tensor) -> tuple[int, int]:
    """(band-frames in a short block mode, band-frames) of uint8 units."""
    m = bitstream.modes(units)
    return int((m != 0).sum()), m.numel()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, devices: tuple[torch.device, ...],
             t0: float, wrap=None) -> tuple[dict, dict]:
    """One run of `cell` on `devices` (its traffic made on the first, which
    also judges): (the result line's object, the compared numbers with
    their limits).  `wrap(step)` may put another step in the program's
    place (the controls and the planted faults of `controls.py`)."""
    home = devices[0]
    gpus = [d for d in dict.fromkeys(devices) if d.type == "cuda"]

    def sync():
        for d in gpus:
            torch.cuda.synchronize(d)
    marks = [("start", t0), ("imports", time.perf_counter())]
    if gpus:
        program.build()
        for d in gpus:
            torch.zeros(1, device=d)
        sync()
    marks.append(("kernels and context", time.perf_counter()))
    chunks, rows, frames, _ = traffic_gen.shape(cell.traffic)
    op = spec.op(cell.op, cell.root)
    with torch.no_grad():
        pcm = traffic_gen.make(cell.traffic, seed, home)
        sync()
        marks.append(("traffic", time.perf_counter()))
        inputs = op.inputs(cell.config, pcm, devices)
        if inputs is not pcm:
            sync()
            marks.append(("inputs made", time.perf_counter()))
        del pcm
        step = op.step(cell.config, devices)
        if wrap is not None:
            step = wrap(step)

        state, t_call = None, 0.0
        for k in range(chunks):                         # warm-up: every call of one track
            t = time.perf_counter()
            out, state = step(inputs[k], state)
            sync()
            t_call = time.perf_counter() - t
        del out, state
        horizon = min(MAX_HORIZON, int(0.5 * seconds / max(t_call, 1e-6)))
        sample = sampled_calls(seed, chunks, horizon)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t0
        log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))

        times, held, state, i = [], {}, None, 0
        start = time.perf_counter()
        while True:
            k = i % chunks
            if k == 0:
                state = None
            t = time.perf_counter()
            out, state = step(inputs[k], state)
            sync()
            end = time.perf_counter()
            times.append(end - t)
            if i in sample:
                held[i] = out
            i += 1
            if end - start >= seconds:
                break
        window_s = end - start
        del out, state
        dev = card(home)
        dev["count"] = cell.chips
        peaks = [torch.cuda.max_memory_allocated(d) for d in gpus] or [0]
        dev["memory_peak_bytes"], dev["memory_peak_bytes_by_card"] = max(peaks), peaks

        work = len(times) * rows * frames
        metrics, layer_ctx = {}, None
        if traced:
            def call(j: int, st={"s": None}):
                if j % chunks == 0:
                    st["s"] = None
                o, st["s"] = step(inputs[j % chunks], st["s"])
                return o
            # on the CPU no operation runs on a device: one card, idle throughout
            tr = trace.profile(call, 2 * chunks, sync, [d.index for d in gpus] or [0])
            layer_ctx = {"trace": tr, "cell": cell, "rows": rows, "frames": frames, "op": op.FAMILY}
            dev["busy_s"], dev["window_s"], dev["busy_s_by_card"] = tr.busy_s, tr.wall_s, tr.busy_s_by_card
            for m in cell.per_layer:
                value = spec.reader(m["name"], cell.root)(layer_ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            produced = {f"{op.FAMILY}_fps": stats.rate(work, window_s),
                        f"{op.FAMILY}_p95_ms": 1e3 * stats.p95(times), "setup_s": setup_s}
            for m in cell.end_to_end:
                if m["name"] not in produced:
                    raise KeyError(f"the harness has no metric {m['name']!r} for a {op.FAMILY} cell")
                metrics[m["name"]] = {"value": produced[m["name"]], "unit": m["unit"]}
        for d in gpus:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()

        missing = sorted(sample - set(held))
        t = time.perf_counter()
        numbers = judge.judge(cell.limits["judge"], inputs, held, lambda c: c % chunks, cell.config)
        if "units" in cell.limits:
            # a decode cell's units came from the program's encoder at set-up: they are held to the
            # reference too, against the tracks made again from the seed
            pcm = traffic_gen.make(cell.traffic, seed, home)
            got = judge.judge(cell.limits["units"], pcm, dict(enumerate(inputs)), lambda c: c, cell.config)
            numbers.update({f"units.{k}": v for k, v in got.items()})
            del pcm
        judge_s = time.perf_counter() - t
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in cell.limits["limits"].items()}
    correct = not missing and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(times), "failed": len(missing), "metrics": metrics,
              "device": dev}
    if layer_ctx is not None:
        result["breakdown"] = layer_ctx["trace"].breakdown()
    # the units of one whole track: the input where the calls read units, or one judged output per chunk
    track = list(inputs) if inputs.dtype == torch.uint8 else [
        next((held[i] for i in sorted(held) if i % chunks == k), None) for k in range(chunks)]
    if all(t is not None and t.dtype == torch.uint8 for t in track):
        short = [short_band_frames(t) for t in track]
        log(f"short band-frames: {sum(s for s, _ in short)} of {sum(n for _, n in short)}")
    q = statistics.quantiles(times, n=100, method="inclusive")
    log(f"call ms: min {1e3 * min(times):.3f}, p50 {1e3 * q[49]:.3f}, p90 {1e3 * q[89]:.3f}, "
        f"p95 {1e3 * q[94]:.3f}, p99 {1e3 * q[98]:.3f}, max {1e3 * max(times):.3f}")
    log(f"window: {len(times)} calls in {window_s:.4f} s, {work} channel-frames; set-up {setup_s:.4f} s; "
        f"judged calls {sorted(held)} in {judge_s:.2f} s" + (f"; never came {missing}" if missing else ""))
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"no result: this cell needs {cell.chips} CUDA card(s); this machine has {have}")
        return 2
    devices = cards(cell.chips)
    t = time.perf_counter()
    torch.cuda.set_device(devices[0])
    for d in devices:
        torch.zeros(1, device=d)
    log(f"process: imports {t - _T0:.3f} s, the cards' contexts {time.perf_counter() - t:.3f} s")
    log(f"cell {cell.name}: config {cell.config['name']}, traffic op {cell.op}, seed {args.seed}, "
        f"{args.seconds} s, trace {args.trace}, {len(devices)} card(s)")
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, _T0)
    log(f"card: {result['device']['kind']}, power limit {result['device'].get('power_limit')}")
    bad = forbidden_modules()
    if bad:
        log(f"no result: modules {bad} were loaded in this process (the benchmark loads no JAX and no carta1_tpu)")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    result["check"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
