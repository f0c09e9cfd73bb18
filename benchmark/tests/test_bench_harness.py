"""The harness end to end on the CPU at a tiny size (it skips only its look
for a card): every cell comes out correct with its metrics; each fault a
cell can have, planted under the timed path, makes it incorrect; nothing
it runs loads JAX or the JAX package; and a new configuration, traffic
mix and metric, added as files alone, make a cell that runs."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import controls, run
from benchmark.tests.conftest import CELLS, ROOT, tiny

ON_CPU = (torch.device("cpu"),)      # the devices of a one-card cell, on the CPU
WINDOW_S = 6.0          # holds every sampled call at the CPU's pace, under load too


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name):
    cell = tiny(name)
    result, checks = run.run_cell(cell, 2**31 + 5, WINDOW_S, False, ON_CPU, time.perf_counter())
    assert result["correct"], checks
    assert result["attempted"] >= 9 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(checks) == set(cell.limits["limits"])


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    cell = tiny(name)
    result, checks = run.run_cell(cell, 99, WINDOW_S, False, ON_CPU, time.perf_counter(), wrap=controls.FAULTS[fault])
    assert not result["correct"] and result["failed"] == 0, checks


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("name", [n for n in CELLS if ".decode." in n])
def test_fault_in_the_units_encoder_is_not_correct(name, fault):
    """A decode cell also holds the units it decodes, made by the program's
    encoder at set-up, to the reference."""
    cell = tiny(name)
    with controls.units_fault(controls.FAULTS[fault]):
        result, checks = run.run_cell(cell, 99, WINDOW_S, False, ON_CPU, time.perf_counter())
    assert not result["correct"] and result["failed"] == 0, checks
    assert checks["pcm_diff_samples"]["value"] == 0           # the decoder itself is sound


def test_traced_run_reads_its_layers():
    cell = tiny("batched.decode.drums")
    result, _ = run.run_cell(cell, 1, 1.0, True, ON_CPU, time.perf_counter())
    assert {"idle_share.decode", "launches_per_call.decode"} <= set(result["metrics"])
    assert {"device_ops", "idle_gaps"} == set(result["breakdown"])
    assert "window_s" in result["device"] and "busy_s" in result["device"]


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import time, torch; from benchmark import run; from benchmark.tests.conftest import tiny, CELLS\n"
            "for n in CELLS:\n"
            "    run.run_cell(tiny(n), 3, 2.0, n.endswith('drums'), (torch.device('cpu'),), time.perf_counter())\n"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "carta1_tpu_torch_like", sys)
    assert "carta1_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell by new files and new entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "sp_stereo_batched.json").read_text())
    cfg.update(name="sp_stereo_bias", options={**cfg["options"], "allocation_bias": 1.5})
    (b / "configs" / "sp_stereo_bias.json").write_text(json.dumps(cfg))
    recipe = json.loads((b / "traffic" / "content" / "album.json").read_text())
    recipe["tones"] = 5
    (b / "traffic" / "content" / "chords.json").write_text(json.dumps(recipe))
    mix = json.loads((b / "traffic" / "album.encode.json").read_text())
    mix["content"] = "chords"
    (b / "traffic" / "chords.encode.json").write_text(json.dumps(mix))
    (b / "metrics" / "calls_profiled.py").write_text("def read(ctx):\n    return float(ctx['trace'].calls)\n")
    (b / "limits" / "bias.encode.chords.json").write_text(
        (b / "limits" / "batched.encode.album.json").read_text())
    bench["configs"].append({"name": "sp_stereo_bias", "source": "x", "file": "benchmark/configs/sp_stereo_bias.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "bias.encode.chords", "config": "sp_stereo_bias", "traffic": "chords.encode",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_profiled", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "encode_fps",
                               "workloads": ["bias.encode.chords"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "batched.encode.album" in m["workloads"]:
            m["workloads"].append("bias.encode.chords")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, torch, json; from pathlib import Path; from benchmark import run, spec\n"
            "c = spec.load('bias.encode.chords', Path('.').resolve())\n"
            "c.traffic.update(tracks=1, frames_per_track=48, chunk_frames=16)\n"
            "r, k = run.run_cell(c, 8, 6.0, True, (torch.device('cpu'),), time.perf_counter())\n"
            "print(json.dumps([r['correct'], r['metrics']['calls_profiled']['value'], run.__file__]))")
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, calls, where = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and calls == 6.0 and where.startswith(str(tmp_path)), out.stderr[-3000:]


MESH_OP = '''"""The sharded encode chunk step over the cell's devices."""

FAMILY = "encode"


def inputs(config, pcm, devices):
    return pcm


def step(config, devices):
    from benchmark import program
    from carta1_tpu_torch import processor
    from carta1_tpu_torch.parallel import sharding

    opts, mesh = program.options(config), sharding.make_mesh(devices)
    return lambda chunk, state: processor._encode_chunk_sharded(chunk, opts, state, mesh)
'''


def test_new_entry_over_two_devices_is_files_alone(tmp_path):
    """A copy of the benchmark gains an entry of the package, the frames of
    each call split over a mesh of two devices, and a cell that drives it,
    by new files and new entries only; the cell is correct under the batched
    encode's judge and reports its family's end-to-end metrics."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "ops" / "encode_mesh.py").write_text(MESH_OP)
    mix = json.loads((b / "traffic" / "album.encode.json").read_text())
    mix["op"] = "encode_mesh"
    (b / "traffic" / "album.encode_mesh.json").write_text(json.dumps(mix))
    (b / "limits" / "mesh.encode.album.json").write_text((b / "limits" / "batched.encode.album.json").read_text())
    bench["workloads"].append({"name": "mesh.encode.album", "config": "sp_stereo_batched",
                               "traffic": "album.encode_mesh", "chips": 2, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("encode_fps", "encode_p95_ms"):
            m["workloads"].append("mesh.encode.album")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # "cpu" and "cpu:0" are two devices to the mesh: each takes half of every row's frames, rebuilds its
    # boundary state from the halo, and the halves are gathered on the first; a window of 12 s, since the
    # sharded step takes about twice the plain one's time and the sampled calls must come
    code = ("import sys, time, torch, json; from pathlib import Path; from benchmark import run, spec\n"
            "c = spec.load('mesh.encode.album', Path('.').resolve())\n"
            "c.traffic.update(tracks=1, frames_per_track=48, chunk_frames=16)\n"
            "mesh = (torch.device('cpu'), torch.device('cpu', 0))\n"
            "r, k = run.run_cell(c, 2**31 + 17, 12.0, False, mesh, time.perf_counter())\n"
            "print(json.dumps([r['correct'], sorted(r['metrics']), [k, r['failed']], run.__file__]))")
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, checks, where = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct, checks
    assert metrics == ["encode_fps", "encode_p95_ms", "setup_s"] and where.startswith(str(tmp_path))
