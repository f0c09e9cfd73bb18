"""The class members of `FrameData` and `AeaMetadata` against the JAX package's.

`FrameData.zeros`, `concatenate` and `to_numpy` and
`AeaMetadata.frames_per_channel`, which the JAX package's entry points and
its users' scripts call (a silent frame to pad with, chunks joined).  No
JAX function is compiled.
"""

import os

import numpy as np
import pytest
import torch

from carta1_tpu.framedata import FrameData as JaxFrameData
from carta1_tpu.io import aea as jax_aea

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import convert, testing
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.io import aea

GOLDEN_AEA = os.path.join(os.path.dirname(__file__), "fixtures", "golden.aea")


def _mixed(nframes: int, seed: int):
    return testing.random_framedata(nframes, seed, np.random.default_rng(seed).choice([0, *C.BFU_AMOUNTS], nframes))


def _assert_fields_equal(got: FrameData, want) -> None:
    for k in FrameData.fields():
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.dtype == torch.int32 and w.dtype == np.int32, k
        assert tuple(g.shape) == w.shape and np.array_equal(g.numpy(), w), k


@pytest.mark.parametrize("nframes", [0, 1, 3])
def test_zeros_matches_jax(nframes):
    _assert_fields_equal(FrameData.zeros(nframes, device="cpu"), JaxFrameData.zeros(nframes))


def test_zeros_without_card_raises(monkeypatch):
    """The card is the default device, with no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameData.zeros(1)


def test_concatenate_matches_jax():
    parts = [testing.random_framedata(3, 1, 52), testing.random_framedata(0, 2, 20), _mixed(5, 3)]
    want = JaxFrameData.concatenate([JaxFrameData(*(getattr(p, k) for k in FrameData.fields())) for p in parts])
    got = FrameData.concatenate([convert.framedata_from_numpy(p, "cpu") for p in parts])
    _assert_fields_equal(got, want)


def test_concatenate_of_channel_parts_is_the_whole():
    """[C, F] parts join on each field's own frame axis."""
    a, b = _mixed(10, 4), _mixed(10, 5)
    whole = convert.framedata_from_numpy(
        FrameData(*(np.stack([getattr(a, k), getattr(b, k)]) for k in FrameData.fields())), "cpu")
    got = FrameData.concatenate([whole[:, :3], whole[:, 3:3], whole[:, 3:]])
    for k in FrameData.fields():
        assert torch.equal(getattr(got, k), getattr(whole, k)), k


def test_to_numpy_gives_int32_arrays_and_round_trips():
    fd = convert.framedata_from_numpy(_mixed(6, 6), "cpu")
    host = fd.to_numpy()
    for k in FrameData.fields():
        x = getattr(host, k)
        assert isinstance(x, np.ndarray) and x.dtype == np.int32, k
    back = convert.framedata_from_numpy(host, "cpu")
    for k in FrameData.fields():
        assert torch.equal(getattr(back, k), getattr(fd, k)), k
    assert host.num_frames == fd.num_frames == 6


@pytest.mark.parametrize("case", ["golden", "stereo", "no_channels"])
def test_frames_per_channel_matches_jax(case, tmp_path):
    if case == "golden":
        meta, jmeta = aea.read_aea(GOLDEN_AEA)[0], jax_aea.read_aea(GOLDEN_AEA)[0]
    elif case == "stereo":
        path = str(tmp_path / "stereo.aea")
        aea.write_aea(path, jax_aea.read_aea(GOLDEN_AEA)[1][:11], "two", channel_count=2)
        meta, jmeta = aea.read_aea(path)[0], jax_aea.read_aea(path)[0]
        assert meta.frames_per_channel == 5
    else:
        meta, jmeta = aea.AeaMetadata("none", 7, 0), jax_aea.AeaMetadata("none", 7, 0)
    assert meta.frames_per_channel == jmeta.frames_per_channel
