"""What a cell is, read from files found by the names in BENCHMARK.json.

  * `BENCHMARK.json` at the root: the cells (`workloads`), their
    configurations and traffic mixes, the metrics;
  * `benchmark/configs/<config>.json`: the engine and its options;
  * `benchmark/traffic/<traffic>.json`: the operation, the shapes and the
    name of the content recipe, `benchmark/traffic/content/<content>.json`
    (`traffic_gen`), which mixes of other operations or shapes share;
  * `benchmark/ops/<op>.py`: the entry of the package that the traffic's
    `op` drives: `FAMILY` ("encode" or "decode", which names the cell's
    end-to-end metrics and is the `op` its metric readers see),
    `inputs(config, pcm, devices)`, what the calls read, made at set-up
    from the traffic's PCM, and `step(config, devices) -> fn(chunk,
    state) -> (output, state)`, over the cell's cards;
  * `benchmark/limits/<workload>.json`: the comparison that decides
    `correct` (`judge`) and the limit of each number it compares;
  * `benchmark/metrics/<metric>.py`: one reader per per-layer metric, a
    function `read(ctx) -> float | None`.

A new cell, configuration, traffic mix, entry or metric is new files and
new entries; no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]           # the metrics this cell reports with --trace 0
    per_layer: list[dict]            # ... and with --trace 1
    root: Path = ROOT                # the checkout the files were read from

    @property
    def op(self) -> str:
        return self.traffic["op"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` (or of `bench`)."""
    bench = bench if bench is not None else _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = load_traffic(w["traffic"], root)
    limits = _json(root / "benchmark" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, layer, root)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    """The traffic mix `name` with its content recipe read in."""
    traffic = _json(root / "benchmark" / "traffic" / f"{name}.json")
    return {**traffic, "content": _json(root / "benchmark" / "traffic" / "content" / f"{traffic['content']}.json")}


def _module(kind: str, name: str, root: Path):
    """The module `root/benchmark/<kind>/<name>.py`, loaded from its file."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The `read` function of `benchmark/metrics/<metric>.py`."""
    return _module("metrics", metric, root).read


def op(name: str, root: Path = ROOT):
    """The module `benchmark/ops/<name>.py`: an entry a cell drives."""
    return _module("ops", name, root)
