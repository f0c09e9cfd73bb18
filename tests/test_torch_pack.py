"""The PyTorch port's device pack against the host packers and the JAX package.

`ops/bitpack.pack_frames` has no kernel of its own (one integer
`scatter_add_`); its bytes must equal `io/bitstream_np.pack_frames` (the
authoritative NumPy packer) for every BFU amount, `pack_frames_fast` (the
native tier) and the JAX in-graph pack (n_bfu 52, the encoder's), and the
port's own unpack must give the fields back.
"""

import jax
import numpy as np
import pytest
import torch

from carta1_tpu.framedata import FrameData as JaxFrameData
from carta1_tpu.gold import gold_encode_frames
from carta1_tpu.io import aea as jax_aea
from carta1_tpu.io.bitstream_np import pack_frames as np_pack
from carta1_tpu.io.bitstream_np import pack_frames_fast
from carta1_tpu.ops import bitpack as jax_bitpack

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import convert, testing
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.io import aea
from carta1_tpu_torch.ops import bitpack

from signals import frames, sine, white_noise


def _signal(nframes=8, seed=5):
    sig = white_noise(seed, 512 * nframes) * 0.5
    sig += sine(997, length=512 * nframes) * 0.3
    return frames(sig.astype(np.float32))


def _random_fd(nframes: int, seed: int, max_wl: int) -> JaxFrameData:
    """Random fields of an n_bfu == 52 frame; coefficients fill their width,
    both signs.  With max_wl 15 most frames overflow the 1696 bits."""
    rng = np.random.default_rng(seed)
    wl = rng.integers(0, max_wl + 1, (nframes, 52)).astype(np.int32)
    bits = C.WORD_LENGTH_BITS[wl]
    lim = np.where(bits > 0, (1 << np.maximum(bits - 1, 0)) - 1, 0)[..., None]
    q = rng.integers(-(1 << 15), 1 << 15, (nframes, 52, 20))
    q = np.where(C.BFU_SLOT_MASK[None] & (bits > 0)[..., None], np.clip(q, -lim - 1, lim), 0).astype(np.int32)
    modes = np.stack([rng.choice([0, 2], nframes), rng.choice([0, 2], nframes), rng.choice([0, 3], nframes)], 1)
    return JaxFrameData(
        n_bfu=np.full(nframes, 52, np.int32), block_modes=modes.astype(np.int32),
        scale_factors=rng.integers(0, 64, (nframes, 52)).astype(np.int32), word_lengths=wl, quantized=q,
    )


def _pack(fd: JaxFrameData) -> np.ndarray:
    return bitpack.pack_frames(convert.framedata_from_numpy(fd, "cpu")).numpy()


def test_pack_of_encoded_frames_matches_host_and_jax_pack():
    fd, _ = gold_encode_frames(_signal(10, seed=13))
    got = _pack(fd)
    assert got.dtype == np.uint8 and got.shape == (10, C.SOUND_UNIT_SIZE)
    assert np.array_equal(got, np_pack(fd))
    assert np.array_equal(got, pack_frames_fast(fd))
    assert np.array_equal(got, np.asarray(jax.jit(jax_bitpack.pack_frames)(fd)))


@pytest.mark.parametrize("max_wl", [3, 6, 15])
def test_pack_of_random_fields_matches_host_pack(max_wl):
    """max_wl 3 stays inside the unit, 6 ends near its last halfwords, 15
    runs far past it: bits beyond bit 1695 are dropped (bitstream.js:24)."""
    fd = _random_fd(40, 20 + max_wl, max_wl)
    got = _pack(fd)
    assert np.array_equal(got, np_pack(fd))
    assert np.array_equal(got, np.asarray(jax.jit(jax_bitpack.pack_frames)(fd)))


def test_pack_without_coefficients_is_the_static_section():
    """Word length 0 everywhere: no field may be shifted by its full width."""
    fd = _random_fd(5, 3, 0)
    got = _pack(fd)
    assert np.array_equal(got, np_pack(fd))
    assert not got[:, 67:].any()


@pytest.mark.parametrize("source", ["encoded", "random"])
def test_unpack_of_pack_gives_the_fields_back(source):
    fd = gold_encode_frames(_signal(10, seed=14))[0] if source == "encoded" else _random_fd(30, 9, 1)   # at most 2 bits a slot: fits the unit
    tfd = convert.framedata_from_numpy(fd, "cpu")
    back = bitpack.unpack_frames(bitpack.pack_frames(tfd))
    for k in tfd.fields():
        assert torch.equal(getattr(back, k), getattr(tfd, k)), k


def test_pack_keeps_channel_axis():
    a, b = _random_fd(6, 1, 4), _random_fd(6, 2, 4)
    both = convert.framedata_from_numpy(
        JaxFrameData(*(np.stack([getattr(a, k), getattr(b, k)]) for k in JaxFrameData.fields())), "cpu"
    )
    got = bitpack.pack_frames(both).numpy()
    assert got.shape == (2, 6, C.SOUND_UNIT_SIZE)
    assert np.array_equal(got[0], np_pack(a)) and np.array_equal(got[1], np_pack(b))


AMOUNTS = [0, *C.BFU_AMOUNTS.tolist()]


def _amount_fd(n_bfu, nframes: int = 7) -> FrameData:
    """Seeded frames (NumPy fields) under one BFU amount, or under amounts
    drawn per frame from AMOUNTS ("mixed")."""
    if n_bfu == "mixed":
        return testing.random_framedata(nframes, 77, np.random.default_rng(77).choice(AMOUNTS, nframes))
    return testing.random_framedata(nframes, 60 + n_bfu, n_bfu)


def _jax_fd(fd: FrameData) -> JaxFrameData:
    return JaxFrameData(*(getattr(fd, k) for k in JaxFrameData.fields()))


@pytest.mark.parametrize("n_bfu", AMOUNTS + ["mixed"])
def test_pack_every_bfu_amount_matches_host_pack(n_bfu):
    """Each frame laid out for its own n_bfu: the header's amount index,
    the scale factors at 16 + 4 n_bfu, the coefficients from 16 + 10 n_bfu."""
    fd = _amount_fd(n_bfu, 27 if n_bfu == "mixed" else 7)
    got = _pack(fd)
    assert np.array_equal(got, np_pack(_jax_fd(fd)))


@pytest.mark.parametrize("n_bfu", AMOUNTS + ["mixed"])
def test_repack_of_host_units_of_every_bfu_amount(n_bfu):
    """Units the host packer wrote (a Sony deck's or atracdenc's amounts)
    come back byte for byte through the port's unpack and pack."""
    units = np_pack(_jax_fd(_amount_fd(n_bfu, 27 if n_bfu == "mixed" else 7)))
    back = bitpack.pack_frames(bitpack.unpack_frames(torch.from_numpy(units)))
    assert np.array_equal(back.numpy(), units)


def test_pack_of_mixed_amounts_keeps_channel_axis():
    a, b = _amount_fd("mixed", 9), testing.random_framedata(9, 8, np.random.default_rng(8).choice(AMOUNTS, 9))
    stacked = FrameData(*(np.stack([getattr(a, k), getattr(b, k)]) for k in FrameData.fields()))
    both = convert.framedata_from_numpy(stacked, "cpu")
    got = bitpack.pack_frames(both).numpy()
    assert got.shape == (2, 9, C.SOUND_UNIT_SIZE)
    assert np.array_equal(got[0], np_pack(_jax_fd(a))) and np.array_equal(got[1], np_pack(_jax_fd(b)))


def test_pack_of_a_silent_frame_is_the_silent_unit():
    """n_bfu 0 writes BFU-amount index 0: the unit the processors pad with."""
    got = bitpack.pack_frames(FrameData.zeros(1, device="cpu")).numpy()
    assert np.array_equal(got[0], C.SILENT_UNIT)
    assert np.array_equal(got, np_pack(JaxFrameData.zeros(1)))


def test_interleave_stereo_matches_jax_package():
    rng = np.random.default_rng(4)
    left, right = (rng.integers(0, 256, (7, 212)).astype(np.uint8) for _ in range(2))
    got = aea.interleave_stereo(left, right)
    assert np.array_equal(got, jax_aea.interleave_stereo(left, right))
    back = aea.deinterleave_stereo(got)
    assert np.array_equal(back[0], left) and np.array_equal(back[1], right)
