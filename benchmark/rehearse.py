"""Noise rehearsal: does the work of a window follow the seed?

    python3 benchmark/rehearse.py --workloads a,b --seeds 1,2,3,4 --seconds 20 [--host-load N] [--out FILE]

Runs every cell as a check runs it, one process a run, twice over the
seeds in turn (s1 s2 s3 s4 s1 s2 s3 s4), and reports for
each end-to-end metric the spread within a seed (the largest relative
difference between two runs of one seed) beside the spread across seeds
(the relative range of the seeds' means), the quartile spread of all the
runs and of each pass over the seeds (a set), each set's with its run
farthest from the median left out, and each run's count of short
band-frames.  Where the spread across
seeds is the larger, the seed still changes the work.

With `--host-load N`, N CPU-bound processes run beside each run, each in
bursts (busy 20-300 ms, then asleep 50-400 ms, drawn from the seed), and
are stopped when the run ends: how far a host whose cores are shared
moves a cell's rate and tail.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import stats  # noqa: E402

REPEATS = 2
HOG = """
import random, sys, time
rng = random.Random(int(sys.argv[1]))
while True:
    t = time.perf_counter() + rng.uniform(0.02, 0.3)
    while time.perf_counter() < t:
        pass
    time.sleep(rng.uniform(0.05, 0.4))
"""


def one(workload: str, seed: int, seconds: float, host_load: int = 0) -> dict:
    hogs = [subprocess.Popen([sys.executable, "-c", HOG, str(seed + j)]) for j in range(host_load)]
    try:
        proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", workload,
                               "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                              cwd=ROOT, capture_output=True, text=True)
    finally:
        for h in hogs:
            h.kill()
        for h in hogs:
            h.wait()
    lines = proc.stdout.strip().splitlines()
    out = {"workload": workload, "seed": seed, "rc": proc.returncode}
    if proc.returncode == 0 and lines:
        res = json.loads(lines[-1])
        out.update(correct=res["correct"], attempted=res["attempted"],
                   metrics={k: v["value"] for k, v in res["metrics"].items()},
                   check={k: v["value"] for k, v in res["check"].items()}, device=res["device"])
    else:
        out["stderr_tail"] = proc.stderr[-3000:]
    m = re.search(r"short band-frames: (\d+) of (\d+)", proc.stderr)
    if m:
        out["short_band_frames"] = [int(m.group(1)), int(m.group(2))]
    m = re.search(r"call ms: (.*)", proc.stderr)
    if m:
        out["call_ms"] = m.group(1)
    m = re.search(r"judged calls .* in ([\d.]+) s", proc.stderr)
    if m:
        out["judge_s"] = float(m.group(1))
    return out


def summary(runs: list[dict]) -> dict:
    """Per metric: within-seed and across-seed spread, quartile spreads."""
    ok = [r for r in runs if "metrics" in r]
    names = sorted({k for r in ok for k in r["metrics"]})
    out = {}
    for name in names:
        by_seed: dict[int, list[float]] = {}
        for r in ok:
            by_seed.setdefault(r["seed"], []).append(r["metrics"][name])
        means = [statistics.fmean(v) for v in by_seed.values()]
        within = max((max(v) - min(v)) / statistics.fmean(v) for v in by_seed.values() if len(v) > 1) \
            if any(len(v) > 1 for v in by_seed.values()) else None
        values = [r["metrics"][name] for r in ok]
        sets = [[r["metrics"][name] for r in ok if r["pass"] == p] for p in range(REPEATS)]
        out[name] = {"within_seed": within, "across_seeds": (max(means) - min(means)) / statistics.median(means),
                     "quartile_spread": stats.spread(values) if len(values) >= 2 else None,
                     "set_spreads": [stats.spread(v) for v in sets if len(v) >= 3],
                     "set_trimmed_spreads": [stats.trimmed_spread(v) for v in sets if len(v) >= 4],
                     "median": statistics.median(values), "n": len(values)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--host-load", type=int, default=0, help="CPU-bound processes beside each run")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    report = {}
    for w in args.workloads.split(","):
        runs = []
        for p in range(REPEATS):
            for s in seeds:
                r = {**one(w, s, args.seconds, args.host_load), "pass": p, "host_load": args.host_load}
                runs.append(r)
                print(json.dumps(r), flush=True)
        report[w] = {"runs": runs, "summary": summary(runs)}
        print(json.dumps({"workload": w, "summary": report[w]["summary"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
