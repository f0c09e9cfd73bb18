"""The readings the limits of `benchmark/limits/` were set from.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 --seconds 4 \
        [--control NAME]... [--fault NAME]... [--no-program] [--out FILE]

For each seed, one run of the cell as the window runs it (`run.run_cell`,
a short window at the cell's own load and sizes, the same calls judged),
first with the program and then with each control in the program's place,
all in one process so the set-up is paid once; one JSON line per run with
the numbers the cell's judge compares.  The largest reading of the sound
runs over a dozen seeds is a limit's lower end, the smallest reading of a
control its upper end.

Controls, the nearest precision below the one the configuration states:

  * `fast_decode` (decode cells): the package's float32 decoder
    (`decode_step_fast`, within one int16 step) in the chunk step's place;
  * `reference_f32` (exact encode): the reference encoder computed in
    float32 instead of float64, in the program's place;
  * `batched_engine` (exact encode): the package's own float32 engine
    (`engine="tpu"`) in the exact engine's place;
  * `tf32` (batched encode): the program with TF32 switched on for its
    matrix products and convolutions (its configuration states float32
    with TF32 off).

Faults (`FAULTS`, `--fault`; the CPU tests in `benchmark/tests/` plant each
in every cell): a step that returns its state unchanged, half of the
rows' outputs left out, one answer altered where it is produced.  With
`--units-fault` the fault is planted in the encoder that makes a decode
cell's units at set-up instead (and `tf32` there switches TF32 on for that
encoder too): the readings of the `units.*` numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import judge, program, run, spec  # noqa: E402
from benchmark.reference import encoder  # noqa: E402


def reference_encode_step(config: dict, cdt):
    """The reference encoder as a chunk step: int16 [R, F, 512] -> units."""
    bias = config["options"].get("allocation_bias", 1.0)

    def fn(chunk, state):
        pcm = chunk.float() / 32768.0
        if state is None:
            state = encoder.init_state(pcm.shape[0], pcm.device)
        return encoder.encode(pcm, state, judge.thresholds(config), bias, cdt)
    return fn


class _TF32:
    """TF32 on for matrix products and convolutions while a run lasts (the
    package turns it off when it is imported, so it is imported first)."""

    def __enter__(self):
        program.load()
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def control(name: str, cell: spec.Cell):
    """(wrap for `run_cell`, a context the run goes inside) of a control."""
    if name == "fast_decode":
        return (lambda step: program.fast_decode_step()), contextlib.nullcontext()
    if name == "reference_f32":
        return (lambda step: reference_encode_step(cell.config, torch.float32)), contextlib.nullcontext()
    if name == "batched_engine":
        cfg = {**cell.config, "engine": "tpu"}
        return (lambda step: spec.op(cell.op, cell.root).step(cfg, run.cards(cell.chips))), contextlib.nullcontext()
    if name == "tf32":
        return None, _TF32()
    raise ValueError(f"unknown control {name!r}")


def state_unchanged(step):
    """A step that hands back the state it was given."""
    def fn(chunk, state):
        out, _ = step(chunk, state)
        return out, state
    return fn


def half_rows(step):
    """The outputs of the second half of the rows left out (zeros)."""
    def fn(chunk, state):
        out, state = step(chunk, state)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, state
    return fn


def altered(step):
    """One answer altered where it is produced: a bit of one value of one
    row's fifth frame, in the middle of its unit or its samples."""
    def fn(chunk, state):
        out, state = step(chunk, state)
        out = out.clone()
        out[0, 5 % out.shape[1], 100] ^= 1
        return out, state
    return fn


FAULTS = {"state_unchanged": state_unchanged, "half_rows": half_rows, "altered": altered}


@contextlib.contextmanager
def units_fault(fault):
    """A decode cell's units made at set-up by an encoder with `fault`."""
    saved = program.encode_track
    program.encode_track = lambda config, pcm: saved(config, pcm, wrap=fault)
    try:
        yield
    finally:
        program.encode_track = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="append", default=[], help="a control to run after the program")
    ap.add_argument("--fault", action="append", default=[], help="a planted fault (FAULTS) to run after the program")
    ap.add_argument("--units-fault", action="append", default=[],
                    help="a fault (FAULTS) planted in the encoder of a decode cell's units")
    ap.add_argument("--no-program", action="store_true", help="run the controls and faults only")
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"controls: this cell needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    sides = (([] if args.no_program else ["program"]) + args.control + [f"fault:{f}" for f in args.fault]
             + [f"units:{f}" for f in args.units_fault])
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            if side == "program":
                wrap, ctx = None, contextlib.nullcontext()
            elif side.startswith("fault:"):
                wrap, ctx = FAULTS[side[len("fault:"):]], contextlib.nullcontext()
            elif side.startswith("units:"):
                wrap, ctx = None, units_fault(FAULTS[side[len("units:"):]])
            else:
                wrap, ctx = control(side, cell)
            t0 = time.perf_counter()
            with ctx:
                result, checks = run.run_cell(cell, seed, args.seconds, False, run.cards(cell.chips), t0,
                                              wrap=wrap)
            line = {"workload": cell.name, "seed": seed, "side": side, "correct": result["correct"],
                    "calls": result["attempted"], "numbers": {k: v["value"] for k, v in checks.items()},
                    "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
