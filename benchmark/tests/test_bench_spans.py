"""The per-layer metrics read from the program's stage spans
(`benchmark/spans.py`), on the CPU at a tiny size: a traced run reports
the host times and the short band-frames with values, and no value (not
0) for the device times, which a step on the CPU does not have; a
program without the spans gives no value and raises nothing."""

import time

import pytest
import torch

from benchmark import program, run, spec, traffic_gen
from benchmark.tests.conftest import tiny

CPU = torch.device("cpu")
HOST = {"encode": {"step_host_ms_per_call.encode"},
        "decode": {"step_host_ms_per_call.decode", "host_wait_ms_per_call.decode", "short_band_frames_per_call.decode"}}


def span_metrics(cell) -> set[str]:
    return {m["name"] for m in cell.per_layer if spec.reader(m["name"], cell.root).__module__ == "benchmark.spans"}


@pytest.mark.parametrize("name", ["batched.encode.album", "exact.encode.album", "batched.decode.drums"])
def test_traced_run_reads_the_spans(name):
    cell = tiny(name)
    result, _ = run.run_cell(cell, 2**31 + 11, 1.0, True, CPU, time.perf_counter())
    got = result["metrics"]
    assert HOST[cell.op] <= set(got)
    assert all(got[m]["value"] > 0 for m in HOST[cell.op])
    assert not (span_metrics(cell) - HOST[cell.op]) & set(got)         # device ms: none on the CPU, not 0


def test_short_band_frames_match_the_units():
    cell = tiny("batched.decode.drums")
    result, _ = run.run_cell(cell, 7, 1.0, True, CPU, time.perf_counter())
    with torch.no_grad():
        units = program.encode_track(cell.config, traffic_gen.make(cell.traffic, 7, CPU))
    # the traced stretch decodes each chunk of the track the same number of times
    shorts = sum(run.short_band_frames(u)[0] for u in units)
    assert shorts > 0
    assert result["metrics"]["short_band_frames_per_call.decode"]["value"] == shorts / len(units)


def test_no_spans_no_value(monkeypatch):
    """Against a program without `profiling.spans` (an older commit) every
    span metric is left out of a traced run's line."""
    from carta1_tpu_torch import profiling

    monkeypatch.delattr(profiling, "spans")
    cell = tiny("batched.decode.album")
    result, _ = run.run_cell(cell, 5, 1.0, True, CPU, time.perf_counter())
    assert not span_metrics(cell) & set(result["metrics"])
    assert {"idle_share.decode", "launches_per_call.decode"} <= set(result["metrics"])
