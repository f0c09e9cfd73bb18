"""The PyTorch port's device pack against the host packers and the JAX package.

On CPU tensors `ops/bitpack.pack_frames` runs its plain version,
`pack_frames_plain` (one integer `scatter_add_`); its bytes must equal
`io/bitstream_np.pack_frames` (the authoritative NumPy packer) for every
BFU amount, `pack_frames_fast` (the native tier) and the JAX in-graph pack
(n_bfu 52, the encoder's), and the port's own unpack must give the fields
back.  On the card it launches K7 (`csrc/bitpack_write.cu`); a NumPy
emulation of K7's thread-to-data map is held to the plain version here,
the kernel itself in `tests/test_torch_kernels_cuda.py`.
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
from carta1_tpu_torch.ops import bitpack, bitpack_kernels

from signals import frames, sine, white_noise


def _signal(nframes=8, seed=5):
    sig = white_noise(seed, 512 * nframes) * 0.5
    sig += sine(997, length=512 * nframes) * 0.3
    return frames(sig.astype(np.float32))


def _random_fd(nframes: int, seed: int, max_wl: int) -> JaxFrameData:
    """Random fields of an n_bfu == 52 frame; coefficients fill their width,
    both signs.  With max_wl 15 most frames overflow the 1696 bits."""
    return _jax_fd(testing.random_fields(nframes, seed, 52, max_wl))


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


@pytest.mark.parametrize("source", ["encoded", "mixed amounts", "channel axis"])
def test_pack_plain_equals_the_default_on_cpu_tensors(source):
    """CPU tensors take the plain version whatever `plain` says."""
    if source == "encoded":
        fd = convert.framedata_from_numpy(gold_encode_frames(_signal(6, seed=15))[0], "cpu")
    elif source == "mixed amounts":
        fd = convert.framedata_from_numpy(_amount_fd("mixed", 19), "cpu")
    else:
        a, b = _amount_fd("mixed", 5), _amount_fd(52, 5)
        fd = convert.framedata_from_numpy(FrameData(*(np.stack([getattr(a, k), getattr(b, k)]) for k in FrameData.fields())), "cpu")
    got = bitpack.pack_frames(fd, plain=True)
    assert torch.equal(got, bitpack.pack_frames(fd)) and torch.equal(got, bitpack.pack_frames_plain(fd))


def _k7_emulation(fd: FrameData) -> np.ndarray:
    """`csrc/bitpack_write.cu` in NumPy, all frames at once: lane l's BFUs 2l
    and 2l + 1 and the warp's inclusive scan of their bits, the 16-byte
    vector v of a frame's coefficients as BFU v // 5, slots 4 (v % 5) on,
    and `put` into 54 uint32 words (the 54th dropped), stored big-endian."""
    nb_in = fd.n_bfu.astype(np.int64)
    n = nb_in.shape[0]
    nb = np.clip(nb_in, 0, 1024)
    rows = np.arange(n)
    words = np.zeros((n, 54), np.uint64)
    specs = C.SPECS_PER_BFU.astype(np.int64)

    def put(off, width, v, take):
        take = take & (off < C.FRAME_BITS)
        r, off, width, v = rows[take], off[take], width[take], v[take].astype(np.uint64) & 0xFFFFFFFF
        word, end = off >> 5, (off & 31) + width
        one = end <= 32
        np.bitwise_or.at(words, (r[one], word[one]), (v[one] << (32 - end[one]).astype(np.uint64)) & 0xFFFFFFFF)
        two = ~one
        np.bitwise_or.at(words, (r[two], word[two]), v[two] >> (end[two] - 32).astype(np.uint64))
        np.bitwise_or.at(words, (r[two], word[two] + 1), (v[two] << (64 - end[two]).astype(np.uint64)) & 0xFFFFFFFF)

    modes = fd.block_modes.astype(np.int64)
    amount = (C.BFU_AMOUNTS[None, :].astype(np.int64) < nb_in[:, None]).sum(axis=1)
    header = ((2 - modes[:, 0]) << 14 | (2 - modes[:, 1]) << 12 | (3 - modes[:, 2]) << 10 | amount << 5) & 0xFFFF
    put(np.zeros(n, np.int64), np.full(n, 16), header, np.ones(n, bool))

    wl = fd.word_lengths.astype(np.int64)
    w = np.zeros((n, 52), np.int64)
    for lane in range(26):
        for i in (2 * lane, 2 * lane + 1):
            act = i < nb
            put(16 + 4 * np.full(n, i), np.full(n, 4), wl[:, i] & 15, act)
            put(16 + 4 * nb + 6 * i, np.full(n, 6), fd.scale_factors[:, i].astype(np.int64) & 63, act)
            w[:, i] = np.where(act & (wl[:, i] > 0), np.minimum(wl[:, i], 15) + 1, 0)
    bits = np.zeros((n, 32), np.int64)
    bits[:, :26] = w[:, 0::2] * specs[0::2] + w[:, 1::2] * specs[1::2]
    start = 16 + 10 * nb[:, None] + np.cumsum(bits, axis=1) - bits
    first = np.stack([start[:, :26], start[:, :26] + w[:, 0::2] * specs[0::2]], axis=2).reshape(n, 52)

    vecs = fd.quantized.astype(np.int64).reshape(n, 260, 4)
    for v in range(260):
        i, k = v // 5, 4 * (v % 5)
        wi = w[:, i]
        if k >= specs[i]:
            continue
        for j in range(min(4, specs[i] - k)):
            put(first[:, i] + (k + j) * wi, wi, vecs[:, v, j] & ((1 << wi) - 1), wi > 0)
    return words[:, :53].astype(">u4").view(np.uint8).reshape(n, C.SOUND_UNIT_SIZE)


PACK_EDGE = testing.pack_edge_cases(bitpack_kernels.BLOCK_FRAMES)


@pytest.mark.parametrize("kind", sorted({name.split(",")[0] for name, _ in PACK_EDGE}))
def test_pack_kernel_map_emulated_matches_plain(kind):
    """K7's thread-to-data map, emulated, gives the plain version's bytes on
    every edge input of the kind (batches around a block's frames)."""
    cases = [(name, fd) for name, fd in PACK_EDGE if name.split(",")[0] == kind]
    assert len(cases) == 4
    for name, fd in cases:
        want = bitpack.pack_frames_plain(convert.framedata_from_numpy(fd, "cpu")).numpy()
        assert np.array_equal(_k7_emulation(fd), want), name


def test_interleave_stereo_matches_jax_package():
    rng = np.random.default_rng(4)
    left, right = (rng.integers(0, 256, (7, 212)).astype(np.uint8) for _ in range(2))
    got = aea.interleave_stereo(left, right)
    assert np.array_equal(got, jax_aea.interleave_stereo(left, right))
    back = aea.deinterleave_stereo(got)
    assert np.array_equal(back[0], left) and np.array_equal(back[1], right)
