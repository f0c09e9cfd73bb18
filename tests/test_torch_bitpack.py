"""The PyTorch port's device unpack and host IO against the JAX package.

On the CPU the field-read kernel wrapper (K3) takes its plain PyTorch
version; the kernel itself is held against that on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from carta1_tpu.constants import BFU_AMOUNTS
from carta1_tpu.framedata import FrameData as JaxFrameData
from carta1_tpu.io import aea as jax_aea
from carta1_tpu.io import wav as jax_wav
from carta1_tpu.io.bitstream_np import pack_frames, unpack_frames, unpack_frames_fast
from carta1_tpu.ops import bitpack as jax_bitpack

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.io import aea, wav
from carta1_tpu_torch.ops import bitpack, bitpack_kernels
from carta1_tpu_torch.ops.pcm import float_to_int16

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _golden_units():
    return jax_aea.read_aea(os.path.join(FIXTURES, "golden.aea"))[1]


def _random_units(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, C.SOUND_UNIT_SIZE)).astype(np.uint8)


def _assert_same_fields(got, want):
    for k in JaxFrameData.fields():
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.dtype == torch.int32, k
        assert np.array_equal(g.numpy(), w), k


@pytest.mark.parametrize("source", ["golden", "random"])
def test_unpack_matches_host_unpack(source):
    units = _golden_units() if source == "golden" else _random_units(200, 1)
    _assert_same_fields(bitpack.unpack_frames(torch.from_numpy(units.copy())), unpack_frames(units))


@pytest.mark.parametrize("amount_idx", range(len(BFU_AMOUNTS)))
def test_unpack_every_bfu_amount(amount_idx):
    """Random payloads under each of the eight BFU_AMOUNTS headers, which
    moves the scale factor and coefficient sections and truncates fields
    at the unit end (bitstream.js:55)."""
    units = _random_units(24, 100 + amount_idx)
    units[:, 1] = (units[:, 1] & 0x1F) | (amount_idx << 5)
    want = unpack_frames(units)
    assert (np.asarray(want.n_bfu) == BFU_AMOUNTS[amount_idx]).all()
    _assert_same_fields(bitpack.unpack_frames(torch.from_numpy(units)), want)


def test_unpack_matches_jax_device_unpack_and_native():
    """K3's module against the JAX in-graph unpack (jitted) and the native tier."""
    units = np.concatenate([_golden_units()[:6], _random_units(6, 2)])
    got = bitpack.unpack_frames(torch.from_numpy(units))
    _assert_same_fields(got, jax.jit(jax_bitpack.unpack_frames)(units))
    _assert_same_fields(got, unpack_frames_fast(units))


def test_unpack_keeps_channel_axis():
    units = np.stack([_golden_units()[:10], _random_units(10, 3)])      # [2, 10, 212]
    got = bitpack.unpack_frames(torch.from_numpy(units))
    assert got.quantized.shape == (2, 10, 52, 20)
    for ch in range(2):
        _assert_same_fields(got[ch], unpack_frames(units[ch]))


def test_read_fields_plain_truncated_and_out_of_range():
    """Fields cut by the unit end keep only the bits they read; anchors
    outside [j_lo, j_hi) read 0 (the JAX `_window_reduce` rule)."""
    units = torch.from_numpy(_random_units(4, 4))
    win32 = bitpack._windows(bitpack._halfwords(units))
    off = torch.tensor([[1690, 1694, 1695, 1696, 1700, 216, 100, 5]] * 4, dtype=torch.int32)
    w = torch.full_like(off, 6)
    got = bitpack_kernels.read_fields_plain(win32, off, w, 13, 107)
    bits = np.unpackbits(units.numpy(), axis=1).astype(np.int64)
    for f in range(4):
        for m, o in enumerate(off[f].tolist()):
            eff = max(0, min(C.FRAME_BITS - o, 6))
            want = 0 if not (13 <= o >> 4 < 107) else int("".join(map(str, bits[f, o:o + eff])) or "0", 2)
            assert int(got[f, m]) == want, (f, o)


def test_silent_unit_matches_pack_of_zero_frame():
    assert np.array_equal(C.SILENT_UNIT, pack_frames(JaxFrameData.zeros(1))[0])


def test_read_aea_matches_jax_package(tmp_path):
    path = os.path.join(FIXTURES, "golden.aea")
    meta, units = aea.read_aea(path)
    jmeta, junits = jax_aea.read_aea(path)
    assert (meta.title, meta.frame_count, meta.channel_count) == (jmeta.title, jmeta.frame_count, jmeta.channel_count)
    assert np.array_equal(units, junits)
    a, b = aea.deinterleave_stereo(units[:10])
    ja, jb = jax_aea.deinterleave_stereo(units[:10])
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    bad = tmp_path / "bad.aea"
    bad.write_bytes(b"\x01" * C.AEA_HEADER_SIZE)
    with pytest.raises(ValueError, match="Invalid AEA file"):
        aea.read_aea(str(bad))


def test_write_wav_matches_jax_package(tmp_path):
    pcm = np.random.default_rng(8).uniform(-1.1, 1.1, (2, 1000)).astype(np.float32)
    jax_wav.write_wav(str(tmp_path / "want.wav"), pcm)
    wav.write_wav(str(tmp_path / "got.wav"), float_to_int16(torch.from_numpy(pcm)).numpy())
    assert (tmp_path / "got.wav").read_bytes() == (tmp_path / "want.wav").read_bytes()
    with pytest.raises(TypeError):
        wav.write_wav(str(tmp_path / "x.wav"), pcm)
