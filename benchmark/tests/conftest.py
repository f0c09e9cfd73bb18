"""Shared helpers of the benchmark's own tests: cells cut to a few frames
so that the program's plain path and the reference run on the CPU."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)         # the tests share the CPU with one another

CELLS = ["batched.encode.album", "batched.decode.album", "exact.encode.album", "batched.decode.drums"]


def tiny(name: str, root: Path = ROOT):
    """The cell `name` with its traffic cut to one stereo track of three
    chunks of 16 frames (everything else as the files say)."""
    from benchmark import spec

    cell = spec.load(name, root)
    cell.traffic.update(tracks=1, frames_per_track=48, chunk_frames=16)
    return cell


@pytest.fixture
def card():
    """The devices of a one-card cell, (cuda:0,), or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    return (torch.device("cuda", 0),)
