"""On the card: each cell's control comes out not correct, at a size a
test run can hold (one stereo track of three chunks of 256 frames).  The
readings that set the limits come from `controls.py` at the cells' own
sizes; this keeps the controls' verdicts from going stale."""

import time

import pytest

from benchmark import controls, run
from benchmark.tests.conftest import tiny

pytestmark = pytest.mark.cuda

CONTROLS = [("batched.decode.album", "fast_decode"), ("batched.decode.drums", "fast_decode"),
            ("exact.encode.album", "reference_f32"), ("exact.encode.album", "batched_engine"),
            ("batched.encode.album", "tf32")]


@pytest.mark.parametrize("name, which", CONTROLS)
def test_control_is_not_correct(card, name, which):
    cell = tiny(name)
    cell.traffic.update(frames_per_track=768, chunk_frames=256)
    sound, _ = run.run_cell(cell, 21, 2.0, False, card, time.perf_counter())
    assert sound["correct"]
    wrap, ctx = controls.control(which, cell)
    with ctx:
        result, checks = run.run_cell(cell, 21, 2.0, False, card, time.perf_counter(), wrap=wrap)
    assert not result["correct"], checks
