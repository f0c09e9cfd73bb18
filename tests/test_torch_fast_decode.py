"""The port's fast decoder, its IMDCT tables and chunk streaming, on the CPU.

The fast decoder (`decode_frames(..., fast=True)`: f32 basis products and
convolutions, no hand kernel) against the JAX package's
`decode_frames(fast=True)` at one shape, the golden fixture's 87 units
(one small JAX compile; the exact decoder is not compiled), and against
the fixture's int16 within one step.  Its tables against the JAX package's
bit for bit.  The streams against the port's chunked batched entry
points.  Inputs are made from a seed with NumPy.
"""

import os

import numpy as np
import pytest
import torch

from carta1_tpu.gold.transforms import imdct_basis as gold_imdct_basis
from carta1_tpu.gold.transforms import qmf_synthesis_stream as gold_qmf_synthesis
from carta1_tpu.io.bitstream_np import unpack_frames as jax_unpack
from carta1_tpu.ops.tables import decoder_imdct_tables as jax_decoder_imdct_tables
from carta1_tpu.pipeline.decoder import decode_frames as jax_decode_frames
from carta1_tpu.pipeline.streaming import chunk_frames_array as jax_chunk_frames_array

from carta1_tpu_torch import EncoderOptions, decode_frames, decode_units, encode_pcm
from carta1_tpu_torch.convert import framedata_from_numpy
from carta1_tpu_torch.io.aea import interleave_stereo, read_aea
from carta1_tpu_torch.ops.bitpack import pack_frames
from carta1_tpu_torch.ops.pcm import float_to_int16
from carta1_tpu_torch.ops.qmf import qmf_synthesis
from carta1_tpu_torch.pipeline.streaming import chunk_frames_array, decode_stream, encode_stream
from carta1_tpu_torch.tables import decoder_imdct_tables, imdct_basis

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CPU = "cpu"
# f32 PCM against the JAX fast decoder: matmul and conv sum in other orders
# on each side; measured 1.8e-7 at most on the golden fixture
FAST_ATOL = 1e-5


@pytest.fixture(scope="module")
def golden():
    """(units, NumPy FrameData, int16 of the reference decoder)."""
    _, units = read_aea(os.path.join(FIXTURES, "golden.aea"))
    return units, jax_unpack(units), np.load(os.path.join(FIXTURES, "golden_decode.npz"))["int16"]


@pytest.mark.parametrize("key", ["long0", "long1", "long2", "short", "short_rev"])
def test_decoder_imdct_tables_bitwise_jax(key):
    got, want = decoder_imdct_tables()[key], jax_decoder_imdct_tables()[key]
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("size", [64, 256, 512])
def test_imdct_basis_bitwise_gold(size):
    assert np.array_equal(imdct_basis(size).view(np.int64), gold_imdct_basis(size).view(np.int64))


def test_fast_decode_matches_jax_fast(golden):
    _, fd, _ = golden
    want, want_st = jax_decode_frames(fd, fast=True)
    got, st = decode_frames(framedata_from_numpy(fd, CPU), device=CPU, fast=True)
    assert got.shape == (87, 512)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= FAST_ATOL
    for k, v in want_st.items():
        assert np.abs(st[k].numpy() - np.asarray(v)).max() <= FAST_ATOL, k


def test_fast_decode_golden_int16_envelope(golden):
    """Within one int16 step of the reference, in fewer than 1% of samples
    (tests/test_golden.py's envelope of the JAX fast decoder)."""
    _, fd, want = golden
    got, _ = decode_frames(framedata_from_numpy(fd, CPU), device=CPU, fast=True)
    diff = np.abs(float_to_int16(got).numpy().reshape(-1).astype(np.int64) - want)
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def test_fast_decode_carries_state_across_chunks(golden):
    _, fd, _ = golden
    tfd = framedata_from_numpy(fd, CPU)
    whole, whole_st = decode_frames(tfd, device=CPU, fast=True)
    a, st = decode_frames(tfd[:37], device=CPU, fast=True)
    b, st = decode_frames(tfd[37:], st, device=CPU, fast=True)
    assert np.abs(torch.cat([a, b]).numpy() - whole.numpy()).max() <= FAST_ATOL
    assert all(np.abs(st[k].numpy() - whole_st[k].numpy()).max() <= FAST_ATOL for k in st)


def test_qmf_synthesis_near_gold():
    """The f32 convolution against the gold engine's f64 tap loop with an f32
    store (the exact synthesis), within a few f32 ulps of the output."""
    rng = np.random.default_rng(1)
    low, high = (rng.standard_normal((2, 6, 128)) * 0.3).astype(np.float32)
    delay = (rng.standard_normal(46) * 0.3).astype(np.float32)
    got, got_d = qmf_synthesis(torch.from_numpy(low), torch.from_numpy(high), torch.from_numpy(delay))
    want, want_d = gold_qmf_synthesis(low.reshape(-1), high.reshape(-1), delay)
    assert np.abs(got.numpy().reshape(-1) - want).max() <= 4e-6
    assert np.array_equal(got_d.numpy(), want_d)


def _stereo_i16(nframes: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, nframes * 512)) * 0.25
    x[:, nframes * 150: nframes * 150 + 256] += 0.6
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def test_streams_equal_the_chunked_entry_points():
    """encode_stream / decode_stream over [nchunks, C, chunk, 512] equal
    encode_pcm / decode_units with the same chunk size, byte for byte."""
    pcm = _stereo_i16(24)
    chunks, n = chunk_frames_array(pcm.reshape(2, 24, 512), 8)
    assert chunks.shape == (3, 2, 8, 512) and chunks.dtype == np.int16 and n == 24
    fds, _ = encode_stream(chunks, EncoderOptions(), device=CPU)
    assert fds.n_bfu.shape == (3, 2, 8)
    units = pack_frames(fds).reshape(3, 2, 8, 212).transpose(0, 1).reshape(2, 24, 212).numpy()
    want = encode_pcm(pcm, device=CPU, chunk_frames=8)
    assert np.array_equal(interleave_stereo(units[0], units[1]), want)

    out, _ = decode_stream(fds, device=CPU)
    got = float_to_int16(out.transpose(0, 1).reshape(2, -1))
    assert torch.equal(got, decode_units(want, 2, device=CPU, chunk_frames=8, to_i16=True))


@pytest.mark.parametrize("nframes", [21, 24])
def test_chunk_frames_array_matches_jax(nframes):
    frames = np.random.default_rng(nframes).standard_normal((2, nframes, 512)).astype(np.float32)
    got, n = chunk_frames_array(frames, 8)
    for ch in range(2):
        want, wn = jax_chunk_frames_array(frames[ch], 8)
        assert n == wn and np.array_equal(got[:, ch], want)
    mono, n = chunk_frames_array(frames[0], 8)
    assert np.array_equal(mono, jax_chunk_frames_array(frames[0], 8)[0])
