"""Each traffic file gives the same shapes and the same class layout under
two seeds, with other samples: the seed draws values, not work."""

from pathlib import Path

import pytest
import torch

from benchmark import spec, traffic_gen
from benchmark.reference import encoder

TRAFFIC = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
SEEDS = (11, 2**31 + 77)


def _small(name: str) -> dict:
    t = spec.load_traffic(name)
    t.update(tracks=1, frames_per_track=384, chunk_frames=128)
    return t


@pytest.mark.parametrize("name", TRAFFIC)
def test_seed_draws_values_not_work(name):
    t = _small(name)
    a, b = (traffic_gen.make(t, s, "cpu") for s in SEEDS)
    assert a.shape == b.shape == (3, 2, 128, 512) and a.dtype == b.dtype == torch.int16
    assert (a != b).float().mean() > 0.5                             # other samples
    assert torch.equal(traffic_gen.make(t, SEEDS[0], "cpu"), a)      # the same seed gives the same samples
    shares = []
    for pcm in (a, b):
        x = pcm.transpose(0, 1).reshape(2, -1, 512).float() / 32768.0
        _, modes, _, _ = encoder.analysis(x, encoder.init_state(2, "cpu"), (1.0, 1.0, 1.0))
        shares.append((modes != 0).float().mean(dim=(0, 1)))
    # the class layout (the share of short band-frames in each band) follows the file, not the seed
    assert torch.allclose(shares[0], shares[1], atol=0.03), shares


def test_whole_chunks_only():
    t = _small(TRAFFIC[0])
    t["frames_per_track"] = 300
    with pytest.raises(ValueError):
        traffic_gen.shape(t)
