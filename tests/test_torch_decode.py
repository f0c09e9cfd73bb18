"""The PyTorch port's decode path against the gold engine and the JAX package.

Runs on the CPU, where every kernel wrapper takes its plain PyTorch
version (the kernels themselves are held against those versions on the
card: tests/test_torch_kernels_cuda.py and chip_smoke.py).  Everything is
compared f32-bitwise (+0 == -0, the rule of tests/test_exact_decode.py).
The gold engine is already pinned bit-identical to the JAX exact decoder,
so whole-slice equality with gold is equality with the JAX decoder; only
small JAX functions are compiled here.
"""

import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from carta1_tpu.constants import WORD_LENGTH_BITS
from carta1_tpu.framedata import FrameData as JaxFrameData
from carta1_tpu.gold import gold_decode_frames
from carta1_tpu.gold.coding import dequantize_js
from carta1_tpu.gold.transforms import imdct, overlap_add_js, qmf_synthesis_stream
from carta1_tpu.io import aea as jax_aea
from carta1_tpu.io.bitstream_np import pack_frames, unpack_frames
from carta1_tpu.io.wav import float_to_int16 as host_float_to_int16
from carta1_tpu.ops.exact_decode import imdct_exact_xla, qmf_synthesis_exact

import carta1_tpu_torch
from carta1_tpu_torch import constants as C
from carta1_tpu_torch import convert, decode_frames, decode_units, testing
from carta1_tpu_torch.ops.coding import quant_range, word_length_bits
from carta1_tpu_torch.ops import exact_decode as X
from carta1_tpu_torch.ops.imdct_kernels import TILE, imdct_mid_plain
from carta1_tpu_torch.ops.pcm import float_to_int16
from carta1_tpu_torch.ops.qmf_kernels import qmf_taps_plain, tile_rows

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return bool(((a.view(np.int32) == b.view(np.int32)) | ((a == 0) & (b == 0))).all())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spectra(rng, rows, cols):
    return (rng.standard_normal((rows, cols)) * np.exp2(rng.integers(-10, 4, (rows, cols)))).astype(np.float32)


def _golden_units():
    return jax_aea.read_aea(os.path.join(FIXTURES, "golden.aea"))[1]


# ---------------------------------------------------------------------------
# Each module against gold
# ---------------------------------------------------------------------------
def test_word_length_closed_forms_match_tables():
    wl = torch.arange(16, dtype=torch.int32)
    bits = word_length_bits(wl)
    assert np.array_equal(bits.numpy(), WORD_LENGTH_BITS)
    assert np.array_equal(bits.numpy(), C.WORD_LENGTH_BITS)
    assert np.array_equal(quant_range(wl).numpy(), (1 << np.maximum(WORD_LENGTH_BITS - 1, 0)) - 1)


def test_dequantize_exact_matches_gold():
    rng = np.random.default_rng(11)
    q = rng.integers(-32767, 32768, (64, 52, 20)).astype(np.int32)
    sf = rng.integers(0, 64, (64, 52)).astype(np.int32)
    wl = rng.integers(0, 16, (64, 52)).astype(np.int32)
    r = (1 << np.maximum(WORD_LENGTH_BITS[wl] - 1, 0)) - 1
    q = np.clip(q, -r[..., None], r[..., None]).astype(np.int32)
    assert _bits_equal(X.dequantize_exact(_t(q), _t(sf), _t(wl)).numpy(), dequantize_js(q, sf, wl))


@pytest.mark.parametrize("mid", [False, True])
@pytest.mark.parametrize("size", [64, 256, 512])
def test_imdct_exact_matches_gold(size, mid):
    x = _spectra(np.random.default_rng(size), 200, size // 2)
    want = imdct(x, size)
    if mid:
        want = want[:, size // 4: 3 * size // 4]
    assert _bits_equal(X.imdct_exact(_t(x), size, mid=mid).numpy(), want)


def test_overlap_add_exact_matches_gold():
    rng = np.random.default_rng(3)
    p = rng.standard_normal((200, 16)).astype(np.float32)
    c = rng.standard_normal((200, 16)).astype(np.float32)
    assert _bits_equal(X.overlap_add_exact(_t(p), _t(c)).numpy(), overlap_add_js(p, c))


def test_qmf_synthesis_exact_matches_gold():
    rng = np.random.default_rng(4)
    low = rng.standard_normal((40, 256)).astype(np.float32)
    high = rng.standard_normal((40, 256)).astype(np.float32)
    delay = rng.standard_normal(46).astype(np.float32)
    g_out, g_d = qmf_synthesis_stream(low.reshape(-1), high.reshape(-1), delay)
    out, d = X.qmf_synthesis_exact(_t(low), _t(high), _t(delay))
    assert _bits_equal(out.numpy(), g_out.reshape(40, 512)) and _bits_equal(d.numpy(), g_d)


def test_float_to_int16_matches_host():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.uniform(-1.2, 1.2, 20000),
        np.array([-1.0, 1.0, 0.0, -0.0, 1.5, -1.5, 1 / 32767, -1 / 32768, 0.5, -0.5]),
        (np.arange(-40, 40) + 0.5) / 32767.0,   # near the positive scale's integer boundaries
    ]).astype(np.float32)
    assert np.array_equal(float_to_int16(_t(x)).numpy(), host_float_to_int16(x))


# ---------------------------------------------------------------------------
# The kernels' yardsticks on the edge inputs of the tiled kernels: batches
# around a block's tile of rows, +0, -0, denormals, overflow at the last
# rounding, lone samples at a row's ends (carta1_tpu_torch/testing.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [64, 256, 512])
def test_imdct_plain_edge_inputs_match_gold(size):
    infs = 0
    for batch, seed in testing.edge_cases(TILE[size]):
        x = testing.imdct_edge_spectra(size, batch, seed)
        with np.errstate(over="ignore"):
            want = imdct(x, size)[:, size // 4: 3 * size // 4]
        assert not np.isnan(want).any()
        infs += int(np.isinf(want).sum())
        assert _bits_equal(imdct_mid_plain(_t(x), size).numpy(), want), (batch, seed)
    assert infs > 0                                         # the overflow rows did overflow


@pytest.mark.parametrize("s", [2, 7, 128, 256])
def test_qmf_plain_edge_inputs_match_gold(s):
    infs = 0
    for frames, seed in testing.edge_cases(tile_rows(s)):
        low, high, delay = testing.qmf_edge_bands(frames, s, seed)
        with np.errstate(over="ignore"):
            if 2 * s >= C.QMF_DELAY:                    # one stream, the halo chained over its frames
                want, _ = qmf_synthesis_stream(low.reshape(-1), high.reshape(-1), delay)
                got, _ = X.qmf_synthesis_exact(_t(low), _t(high), _t(delay), plain=True)
            else:                                       # frames shorter than the halo: one stream per row
                work = testing.qmf_edge_work(frames, s, seed)
                want, _ = qmf_synthesis_stream(low, high, work[:, :C.QMF_DELAY])
                got = qmf_taps_plain(_t(work))
        assert not np.isnan(want).any()
        infs += int(np.isinf(want).sum())
        assert _bits_equal(got.numpy().reshape(want.shape), want), (frames, seed)
    assert infs > 0 or 2 * s < C.QMF_DELAY                  # a short row holds no full window of F32_MAX


# ---------------------------------------------------------------------------
# Each kernel module's plain version against its JAX function
# ---------------------------------------------------------------------------
def test_imdct_plain_matches_jax_xla():
    x = _spectra(np.random.default_rng(64), 24, 32)
    want = jax.jit(lambda v: imdct_exact_xla(v, 64))(x)
    assert _bits_equal(X.imdct_exact(_t(x), 64).numpy(), want)


def test_qmf_plain_matches_jax():
    rng = np.random.default_rng(6)
    low = rng.standard_normal((40, 256)).astype(np.float32)
    high = rng.standard_normal((40, 256)).astype(np.float32)
    delay = rng.standard_normal(46).astype(np.float32)
    w_out, w_d = jax.jit(qmf_synthesis_exact)(low, high, delay)
    out, d = X.qmf_synthesis_exact(_t(low), _t(high), _t(delay))
    assert _bits_equal(out.numpy(), w_out) and _bits_equal(d.numpy(), w_d)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------
def _assert_matches_gold(fd, gold_state=None, state=None, split=None):
    """Port decode (optionally in two chunks at `split`) == gold, state included."""
    gpcm, gst = gold_decode_frames(fd, gold_state)
    tfd = convert.framedata_from_numpy(fd, CPU)
    if split is None:
        pcm, st = decode_frames(tfd, state, device=CPU)
    else:
        p1, st = decode_frames(tfd[:split], state, device=CPU)
        p2, st = decode_frames(tfd[split:], st, device=CPU)
        pcm = torch.cat([p1, p2])
    assert _bits_equal(pcm.numpy(), gpcm)
    for k, v in convert.state_to_numpy(st).items():
        assert _bits_equal(v, gst[k]), k


def test_golden_fixture_int16_exact():
    golden = np.load(os.path.join(FIXTURES, "golden_decode.npz"))["int16"]
    got = decode_units(_golden_units(), 1, device=CPU, to_i16=True)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy().reshape(-1), golden)


def test_golden_fixture_matches_gold_chunked_and_batched():
    fd = unpack_frames(_golden_units())
    _assert_matches_gold(fd)
    _assert_matches_gold(fd, split=37)


def test_mid_stream_state_from_gold():
    """Gold decodes the first frames; the port takes over from its state."""
    fd = unpack_frames(_golden_units())
    _, gst = gold_decode_frames(fd[:30])
    rest = JaxFrameData(*(np.asarray(getattr(fd, k))[30:] for k in JaxFrameData.fields()))
    _assert_matches_gold(rest, gold_state=gst, state=convert.state_from_numpy(gst, CPU), split=20)


def _forced_modes(fd, modes):
    return JaxFrameData(fd.n_bfu, modes.astype(np.int32), fd.scale_factors, fd.word_lengths, fd.quantized)


@pytest.mark.parametrize("pattern", ["fixture", "all_long", "all_short", "random"])
def test_block_mode_mixes_match_gold(pattern):
    fd = unpack_frames(_golden_units())
    nf = fd.num_frames
    if pattern == "fixture":
        counts = (fd.block_modes != 0).sum(axis=0)
        assert counts.min() > 0 and counts.max() < nf          # mixed, not degenerate
    elif pattern == "all_long":
        fd = _forced_modes(fd, np.zeros((nf, 3)))
    elif pattern == "all_short":
        fd = _forced_modes(fd, np.tile([2, 2, 3], (nf, 1)))
    else:
        pick = np.random.default_rng(9).integers(0, 2, (nf, 3))
        fd = _forced_modes(fd, pick * np.array([2, 2, 3]))
    _assert_matches_gold(fd, split=nf // 3)


def test_stereo_decode_units_odd_count_matches_gold():
    units = _golden_units()                                  # 87 units: odd
    padded = np.concatenate([units, pack_frames(JaxFrameData.zeros(1))])
    want = [gold_decode_frames(unpack_frames(padded[ch::2]))[0].reshape(-1) for ch in (0, 1)]
    got = decode_units(units, 2, device=CPU, chunk_frames=16)
    assert got.shape == (2, 44 * 512)
    assert _bits_equal(got[0].numpy(), want[0]) and _bits_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("n_bfu", [*C.BFU_AMOUNTS.tolist(), "mixed"])
def test_decode_units_of_every_bfu_amount_matches_gold(n_bfu):
    """Units the JAX host packer wrote under each BFU amount (a Sony deck's
    or atracdenc's), random block modes, decode f32-bitwise to gold."""
    if n_bfu == "mixed":
        n_bfu = np.random.default_rng(81).choice([0, *C.BFU_AMOUNTS], 9)
        fd = testing.random_framedata(9, 81, n_bfu)
    else:
        fd = testing.random_framedata(7, 80 + n_bfu, n_bfu)
    units = pack_frames(JaxFrameData(*(getattr(fd, k) for k in JaxFrameData.fields())))
    want, _ = gold_decode_frames(unpack_frames(units))
    got = decode_units(units, 1, device=CPU)
    assert _bits_equal(got.numpy().reshape(-1), want.reshape(-1))


def test_decode_units_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_units(_golden_units()[:4], 1)


def test_package_imports_no_jax():
    """The port and chip_smoke.py load neither JAX nor the JAX package."""
    mods = [m.name for m in pkgutil.walk_packages(carta1_tpu_torch.__path__, "carta1_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'carta1_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15
