"""The PyTorch port's encoder against the JAX package and the gold engine, on the CPU.

The same NumPy-seeded inputs go through the JAX function and its
counterpart in the port; each comparison states its tolerance.  On the CPU
the allocators (K4) run their plain PyTorch version; the kernel itself is
held against that on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py), and the merge it runs against the plain version on the
CPU (tests/test_torch_alloc.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carta1_tpu import constants as JC
from carta1_tpu.framedata import FrameData as JaxFrameData
from carta1_tpu.gold import gold_decode_frames, gold_encode_frames
from carta1_tpu.gold import coding as gold_coding
from carta1_tpu.gold.encoder import _analysis_bands, _group_bfus, _mdct_band
from carta1_tpu.gold.encoder import encoder_init_state as gold_init_state
from carta1_tpu.io import wav as jax_wav
from carta1_tpu.io.bitstream_np import unpack_frames_fast
from carta1_tpu.ops import bitalloc as jax_bitalloc
from carta1_tpu.ops import coding as jax_coding
from carta1_tpu.ops import mdct as jax_mdct
from carta1_tpu.ops import pcm as jax_pcm
from carta1_tpu.ops import qmf as jax_qmf
from carta1_tpu.ops import tables as jax_tables
from carta1_tpu.ops import transient as jax_transient
from carta1_tpu.options import OPTION_METADATA as JAX_OPTION_METADATA
from carta1_tpu.options import EncoderOptions as JaxEncoderOptions
from carta1_tpu.pipeline import encode_frames as jax_encode_frames

import carta1_tpu_torch as port
from carta1_tpu_torch import constants as C
from carta1_tpu_torch import convert, tables, testing
from carta1_tpu_torch.ops import bitalloc, bitalloc_kernels, coding, mdct, pcm, qmf, transient
from carta1_tpu_torch.options import OPTION_METADATA
from carta1_tpu_torch.processor import _encode_batch_dev, pcm_to_frames

from signals import chirp, frames, sine, white_noise

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
N_SWEEP_CASES = 14
RDO_FRAMES = 48                      # the frame count of both RDO tests against JAX


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _signal(nframes=8, seed=5):
    sig = white_noise(seed, 512 * nframes) * 0.5
    sig += sine(997, length=512 * nframes) * 0.3
    return frames(sig.astype(np.float32))


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _used_bits(wl: np.ndarray) -> np.ndarray:
    return (C.WORD_LENGTH_BITS[wl] * C.SPECS_PER_BFU[None, :]).sum(axis=1)


def _psnr_vs_source(src_frames: np.ndarray, fd) -> float:
    """Round-trip SNR through the gold decoder (tests/test_true_rdo.py `_psnr`)."""
    out, _ = gold_decode_frames(fd)
    x = src_frames.reshape(-1)[: out.size - C.CODEC_DELAY].astype(np.float64)
    y = np.asarray(out).reshape(-1)[C.CODEC_DELAY: C.CODEC_DELAY + len(x)].astype(np.float64)
    return 10 * np.log10(np.mean(x**2) / max(np.mean((x - y) ** 2), 1e-30))


def _jax_fd(fd) -> JaxFrameData:
    return JaxFrameData(**convert.framedata_to_numpy(fd))


# ---------------------------------------------------------------------------
# tables, constants, options
# ---------------------------------------------------------------------------
def test_encoder_mdct_tables_bitwise_equal_jax_package():
    want, got = jax_tables.encoder_mdct_tables(), tables.encoder_mdct_tables()
    assert sorted(want) == sorted(got)
    for k in want:
        assert _same_bits(got[k], want[k]), k
    for size in (64, 256, 512):
        from carta1_tpu.gold.transforms import mdct_basis

        assert _same_bits(tables.mdct_basis(size), mdct_basis(size)), size


@pytest.mark.parametrize(
    "name", ["QUANT_RANGES", "RDO_STEP_GAIN", "RDO_STEP_BITS", "RDO_CAND_BFU", "RDO_CAND_WL", "RDO_CAND_COST", "RDO_BUDGET"]
)
def test_quantizer_tables_bitwise_equal_jax_package(name):
    got, want = getattr(tables, name), getattr(jax_tables, name)
    if isinstance(want, int):
        assert got == want == 1136
    else:
        assert _same_bits(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize(
    "name",
    ["QMF_KERNEL_LOW", "QMF_KERNEL_HIGH", "TRANSIENT_FFT_SIZES", "MDCT_TRANSFORM_SIZES", "MDCT_WINDOW_START",
     "BFU_GATHER_IDX", "FRAME_OVERHEAD_BITS", "BITS_PER_BFU_METADATA", "INV_POWER_OF_TWO", "CODEC_DELAY"],
)
def test_encoder_constants_equal_jax_package(name):
    got, want = getattr(C, name), getattr(JC, name)
    if isinstance(want, np.ndarray):
        assert _same_bits(got, want)
    else:
        assert got == want


def test_options_same_fields_ranges_and_errors():
    assert OPTION_METADATA == JAX_OPTION_METADATA
    a, b = port.EncoderOptions(), JaxEncoderOptions()
    assert a.to_dict() == b.to_dict() and a.allocator == b.allocator == "rdo"
    assert a.band_thresholds == b.band_thresholds == (1.0, 1.0, 1.0)
    opts = port.EncoderOptions(transient_threshold_mid=2.5, per_band_thresholds=True)
    assert opts.band_thresholds == (1.0, 2.5, 2.0)
    assert opts.replace(allocation_bias=0.7).allocation_bias == 0.7
    assert port.EncoderOptions.metadata("allocation_bias")["range"] == (0.5, 3.0)
    for bad in (dict(allocation_bias=5.0), dict(transient_threshold_low=0.0), dict(allocator="heap")):
        with pytest.raises(ValueError) as got:
            port.EncoderOptions(**bad)
        with pytest.raises(ValueError) as want:
            JaxEncoderOptions(**bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# modules, one by one
# ---------------------------------------------------------------------------
def test_int16_to_float_bitwise():
    s = np.random.default_rng(1).integers(-32768, 32768, 5000).astype(np.int16)
    s[:3] = (-32768, 32767, 0)
    got = pcm.int16_to_float(_t(s)).numpy()
    assert _same_bits(got, np.asarray(jax_pcm.int16_to_float(jnp.asarray(s))))
    assert _same_bits(got, jax_wav.int16_to_float(s))


def test_qmf_analysis_close_to_jax_and_gold():
    """atol 2e-6 (the JAX suite's own, tests/test_tpu_engine.py): f32 sums
    of 48 products in another order than the gold engine's f64 loop."""
    x = _signal(4)
    gold_bands, gold_state = _analysis_bands(x, gold_init_state())
    z = lambda n: torch.zeros(n)  # noqa: E731
    low1, high1, d1 = qmf.qmf_analysis(_t(x), z(46))
    low2, mid2, d2 = qmf.qmf_analysis(low1, z(46))
    band2, d3 = qmf.delay_stream(high1, z(39))
    for got, want in zip((low2, mid2, band2), gold_bands):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    for got, key in ((d1, "qmf_low_delay"), (d2, "qmf_mid_delay"), (d3, "qmf_high_delay")):
        np.testing.assert_allclose(got.numpy(), gold_state[key], atol=2e-6)
    jl, jh, jd = jax_qmf.qmf_analysis(jnp.asarray(x), jnp.zeros(46))
    np.testing.assert_allclose(low1.numpy(), np.asarray(jl), atol=2e-6)
    np.testing.assert_allclose(high1.numpy(), np.asarray(jh), atol=2e-6)
    assert _same_bits(d1.numpy(), np.asarray(jd))
    # a leading channel axis is two independent streams
    two = torch.stack([_t(x), _t(x[::-1].copy())])
    both = qmf.qmf_analysis(two, torch.zeros(2, 46))
    assert torch.equal(both[0][0], low1) and torch.equal(both[1][0], high1)


@pytest.mark.parametrize("band_idx,size", [(0, 128), (1, 128), (2, 256)])
@pytest.mark.parametrize("mode_val", [0, 2])
def test_encoder_mdct_band_close_to_jax_and_gold(band_idx, size, mode_val):
    """atol 5e-5 for the coefficients, 1e-6 for the tail (the JAX suite's
    own): f32 basis products against the gold engine's FFT with f32 stores."""
    rng = np.random.default_rng(band_idx)
    band = (rng.standard_normal((6, size)) * 0.3).astype(np.float32)
    modes = np.full(6, mode_val, np.int32)
    tail0 = (rng.standard_normal(32) * 0.3).astype(np.float32)
    want, want_tail = _mdct_band(band.copy(), band_idx, modes, tail0)
    got, got_tail = mdct.encoder_mdct_band(_t(band), band_idx, _t(modes), _t(tail0))
    jgot, jtail = jax_mdct.encoder_mdct_band(jnp.asarray(band), band_idx, jnp.asarray(modes), jnp.asarray(tail0))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=5e-5)
    np.testing.assert_allclose(got_tail.numpy(), want_tail, atol=1e-6)
    assert _same_bits(got_tail.numpy(), np.asarray(jtail))


def test_block_modes_equal_jax_and_gold():
    """Exact, given identical band inputs: a score is far from its threshold
    on these signals, so the f32 FFTs' last ulps decide nothing."""
    from carta1_tpu.gold.encoder import _block_modes

    n = 24
    sig = 0.05 * sine(440, length=512 * n)
    sig[512 * 7 + 100: 512 * 7 + 356] += 0.7
    sig[512 * 15: 512 * 15 + 64] -= 0.5
    x = frames(np.clip(sig, -1, 1).astype(np.float32))
    bands, _ = _analysis_bands(x, gold_init_state())
    rng = np.random.default_rng(2)
    prev = [np.abs(rng.standard_normal(s // 2)).astype(np.float32) * 0.01 for s in C.TRANSIENT_FFT_SIZES]
    got, got_specs = transient.block_modes([_t(b) for b in bands], [_t(p) for p in prev], (1.0, 1.0, 1.0))
    # one XLA program per reference, not one per primitive and shape
    want, want_specs = jax.jit(jax_transient.block_modes, static_argnums=2)(list(bands), prev, (1.0, 1.0, 1.0))
    jax_score = jax.jit(jax_transient.transient_score)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != 0).any() and (got.numpy() == 0).any()
    state = dict(gold_init_state(), **{f"prev_spectrum{b}": prev[b] for b in range(3)})
    gold_modes, _ = _block_modes(bands, JaxEncoderOptions(), state)
    assert np.array_equal(got.numpy(), gold_modes)
    for g, w in zip(got_specs, want_specs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)       # two f32 FFTs
    for b in range(3):
        spec = transient.magnitude_spectrum(_t(bands[b]), C.TRANSIENT_FFT_SIZES[b])
        score = transient.transient_score(spec[1:], spec[:-1]).numpy()
        jscore = np.asarray(jax_score(spec.numpy()[1:], spec.numpy()[:-1]))
        np.testing.assert_allclose(score, jscore, rtol=1e-5, atol=1e-6)        # f32 log, exp, log10, log1p


def test_group_bfus_equals_jax_and_gold():
    rng = np.random.default_rng(3)
    coeffs = rng.standard_normal((16, 512)).astype(np.float32)
    modes = np.stack([rng.choice([0, 2], 16), rng.choice([0, 2], 16), rng.choice([0, 3], 16)], 1).astype(np.int32)
    got = coding.group_bfus(_t(coeffs), _t(modes)).numpy()
    assert _same_bits(got, np.asarray(jax_coding.group_bfus(jnp.asarray(coeffs), jnp.asarray(modes))))
    assert _same_bits(got, _group_bfus(coeffs, modes))
    back = coding.scatter_bfus(_t(got), _t(modes), torch.full((16,), 52))
    assert _same_bits(back.numpy(), coeffs)
    per_band = rng.integers(0, 9, (5, 3)).astype(np.int32)
    assert np.array_equal(
        coding.expand_band_to_bfu(_t(per_band)).numpy(), np.asarray(jax_coding.expand_band_to_bfu(jnp.asarray(per_band)))
    )


def _bfu_inputs(nframes, seed):
    """BFU data whose peaks match random scale factors, and random word lengths."""
    rng = np.random.default_rng(seed)
    sf = rng.integers(0, 64, (nframes, 52)).astype(np.int32)
    wl = rng.integers(0, 16, (nframes, 52)).astype(np.int32)
    bfu = rng.uniform(-1, 1, (nframes, 52, 20)) * C.SCALE_FACTORS[sf][..., None]
    return np.where(C.BFU_SLOT_MASK[None], bfu, 0).astype(np.float32), sf, wl


def test_quantize_and_dequantize_equal_jax():
    bfu, sf, wl = _bfu_inputs(12, 4)
    q = coding.quantize(_t(bfu), _t(sf), _t(wl))
    jq = jax_coding.quantize(jnp.asarray(bfu), jnp.asarray(sf), jnp.asarray(wl))
    assert q.dtype == torch.int32 and np.array_equal(q.numpy(), np.asarray(jq))
    assert (q.numpy() != 0).any()
    deq = coding.dequantize(q, _t(sf), _t(wl)).numpy()
    assert _same_bits(deq, np.asarray(jax_coding.dequantize(jq, jnp.asarray(sf), jnp.asarray(wl))))
    # values far beyond the range clamp to it, whatever the float is
    big = coding.quantize(_t(bfu * 1e30), _t(sf), _t(wl)).numpy()
    assert np.array_equal(big, np.asarray(jax_coding.quantize(jnp.asarray(bfu * 1e30), jnp.asarray(sf), jnp.asarray(wl))))


def test_find_scale_factors_equals_jax_and_gold_on_signals():
    x = _signal(12, seed=3)
    bands, _ = _analysis_bands(x, gold_init_state())
    parts = [_mdct_band(bands[b], b, np.zeros(12, np.int32), np.zeros(32, np.float32))[0] for b in range(3)]
    bfu = _group_bfus(np.concatenate(parts, axis=1), np.zeros((12, 3), np.int32))
    got = coding.find_scale_factors(_t(bfu)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, gold_coding.find_scale_factors(bfu, C.BFU_SLOT_MASK))
    assert np.array_equal(got, np.asarray(jax_coding.find_scale_factors(jnp.asarray(bfu))))


def test_find_scale_factors_equals_gold_around_every_table_value():
    """Every f32 within 4 ulps of a table value 2^(i/3 - 21), where the
    reference's ceil(3 * (log2(a) + 21)) changes its mind; plus 0, the
    smallest denormal and values past the table's ends."""
    amps = np.concatenate([testing.scale_factor_edge_amplitudes(), np.array([0.0, 1e-45, 1e-12, 1.0, 3.0, 1e30], np.float32)])
    bfu = np.zeros((amps.size, 52, 20), np.float32)
    bfu[:, :, 0] = amps[:, None]
    bfu[:, 1::2, 0] *= -1
    bfu[:, :, 19] = 7.0             # a padding slot of most BFUs: masked out
    bfu[:, 44:, 19] = amps[:, None] * 0.5
    got = coding.find_scale_factors(_t(bfu)).numpy()
    assert np.array_equal(got, gold_coding.find_scale_factors(bfu, C.BFU_SLOT_MASK))


@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_allocate_bits_equals_jax_and_gold_sweep(bias):
    """Exact: integer keys, one sort, one sweep.  Frames are allocated
    independently, so the JAX reference takes both inputs in one call."""
    fd_gold, _ = gold_encode_frames(_signal(16, seed=11))
    rng = np.random.default_rng(8)
    rand = rng.integers(0, 64, (32, 52)).astype(np.int32)
    rand[:4] = 0                                    # silent frames: nothing valid
    rand[4:8] = 63                                  # everything loud: the budget runs out early
    inputs = (fd_gold.scale_factors, rand)
    want_jax = np.asarray(jax_bitalloc.allocate_bits(jnp.asarray(np.concatenate(inputs)), bias))
    for sf, jax_wl in zip(inputs, np.split(want_jax, [len(inputs[0])])):
        got = bitalloc.allocate_bits(_t(sf), bias).numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got, gold_coding.allocate_bits_sweep(sf, C.SPECS_PER_BFU, bias))
        assert np.array_equal(got, jax_wl)
        assert (_used_bits(got) <= tables.RDO_BUDGET).all() and (got[sf == 0] == 0).all()


@pytest.mark.parametrize("case", range(N_SWEEP_CASES))
def test_alloc_sweep_plain_equals_reference_loop(case):
    cases = testing.sweep_edge_cases(bitalloc_kernels.BLOCK_FRAMES)
    assert len(cases) == N_SWEEP_CASES
    name, cands = cases[case]
    got = bitalloc_kernels.alloc_sweep_plain(_t(cands)).numpy()
    assert got.dtype == np.int32 and got.shape == (cands.shape[0], 52), name
    assert np.array_equal(got, testing.sweep_reference(cands, tables.RDO_BUDGET)), name


def test_alloc_sweep_edge_cases_do_what_their_names_say():
    cases = dict(testing.sweep_edge_cases(bitalloc_kernels.BLOCK_FRAMES))
    ref = lambda name: testing.sweep_reference(cases[name], tables.RDO_BUDGET)  # noqa: E731
    assert not ref("all candidates invalid").any()
    assert not ref("every BFU abandoned at once").any()
    exact = ref("budget met exactly, then zero-cost steps")
    assert exact[0, :4].tolist() == [1, 0, 3, 0]
    assert ref("zero-cost steps only").sum() == (cases["zero-cost steps only"] & 1).sum()
    with pytest.raises(ValueError):
        bitalloc_kernels.alloc_sweep_plain(torch.zeros(4, 780, dtype=torch.int64))
    with pytest.raises(ValueError):
        bitalloc_kernels.alloc_sweep_plain(torch.zeros(4, 0, dtype=torch.int32))


@pytest.mark.parametrize("bias", [1.0, 2.0])
def test_allocate_bits_rdo_against_jax(bias):
    """Not bitwise by contract: the port sums the 20 squared errors left to
    right (the order its kernel repeats), XLA in an order of its own, so
    slopes can differ in the last ulp and, at near-ties, the sweep order
    with them.  Measured on this input: 1.0 of the word lengths equal at
    bias 1.0 and at bias 2.0; asserted >= 0.99."""
    rng = np.random.default_rng(11)
    bfu = (rng.standard_normal((RDO_FRAMES, 52, 20)) * 0.3).astype(np.float32)
    sf = rng.integers(0, 64, (RDO_FRAMES, 52)).astype(np.int32)
    got = bitalloc.allocate_bits_rdo(_t(bfu), _t(sf), bias).numpy()
    want = np.asarray(jax_bitalloc.allocate_bits_rdo(jnp.asarray(bfu), jnp.asarray(sf), bias))
    assert (_used_bits(got) + 40 + 10 * 52 <= 1696).all()
    assert (got >= 0).all() and (got <= 15).all() and (got[sf == 0] == 0).all()
    equal = (got == want).mean()
    print(f"allocate_bits_rdo bias {bias}: {equal:.6f} of word lengths equal JAX's")
    assert equal >= 0.99


def test_allocate_bits_rdo_stable_order_on_exact_ties():
    """Every BFU of a size class holds the same coefficients and scale
    factor, so their steps tie exactly; the stable order (candidate index:
    lower BFU first) decides who gets the last bits.  Exact against JAX.  Six
    loudness levels, repeated to the other RDO test's frame count so that
    the JAX reference compiles at one shape."""
    rng = np.random.default_rng(5)
    proto = (rng.standard_normal(20) * 0.2).astype(np.float32)
    bfu = np.where(C.BFU_SLOT_MASK, proto[None, :], 0).astype(np.float32)[None].repeat(RDO_FRAMES, axis=0)
    bfu *= np.exp2(-(np.arange(RDO_FRAMES) % 6).astype(np.float32))[:, None, None]
    sf = coding.find_scale_factors(_t(bfu))
    got = bitalloc.allocate_bits_rdo(_t(bfu), sf, 1.0).numpy()
    want = np.asarray(jax_bitalloc.allocate_bits_rdo(jnp.asarray(bfu), jnp.asarray(sf.numpy()), 1.0))
    assert np.array_equal(got, want)
    # inside a class of equal BFUs an earlier BFU never gets fewer steps, and
    # in some class the budget ends between two of them
    broken = 0
    for size in np.unique(C.SPECS_PER_BFU):
        cls = got[:, C.SPECS_PER_BFU == size]
        assert (np.diff(cls, axis=1) <= 0).all(), size
        broken += int((cls[:, 0] != cls[:, -1]).any())
    assert broken > 0, "no tie was broken: the input does not test the order"


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def test_encode_frames_reference_allocator_matches_gold_and_jax():
    x = _signal(12, seed=3)
    fd_gold, _ = gold_encode_frames(x)
    fd_jax, jax_state = jax_encode_frames(x, JaxEncoderOptions(allocator="reference"))
    fd_jax = fd_jax.to_numpy()
    fd, state = port.encode_frames(x, port.EncoderOptions(allocator="reference"), device=CPU)
    got = convert.framedata_to_numpy(fd)
    assert all(v.dtype == np.int32 for v in got.values()) and (got["n_bfu"] == 52).all()
    for want in (fd_gold, fd_jax):
        assert np.array_equal(got["block_modes"], want.block_modes)
        assert np.array_equal(got["scale_factors"], want.scale_factors)
    # integer from the scale factors on: equal to the JAX allocator's; the
    # gold heap breaks priority ties in another order than the sweep
    assert np.array_equal(got["word_lengths"], fd_jax.word_lengths)
    assert np.array_equal(got["word_lengths"], gold_coding.allocate_bits_sweep(fd_gold.scale_factors, C.SPECS_PER_BFU, 1.0))
    assert (np.abs(_used_bits(got["word_lengths"]) - _used_bits(fd_gold.word_lengths)) <= 8).all()
    same = got["word_lengths"] == fd_gold.word_lengths
    assert same.mean() > 0.9 and np.array_equal(got["quantized"][same], fd_gold.quantized[same])
    # quantized integers against JAX: f32 MDCT coefficients in another summation order may cross a rounding boundary
    qdiff = np.abs(got["quantized"] - fd_jax.quantized)
    assert qdiff.max() <= 1 and (qdiff != 0).mean() < 1e-3
    for k, v in convert.state_to_numpy(state).items():
        np.testing.assert_allclose(v, np.asarray(jax_state[k]), atol=1e-4, err_msg=k)


def _rdo_signals():
    n = 20 * 512
    burst = 0.05 * sine(440, length=n)
    burst[n // 2: n // 2 + 256] += 0.7
    return {
        "chirp": (0.5 * chirp(50, 15000, length=n)).astype(np.float32),
        "noise": (0.3 * white_noise(5, n)).astype(np.float32),
        "burst": np.clip(burst, -1, 1).astype(np.float32),
        "multitone": (0.3 * sine(440, length=n) + 0.2 * sine(3000, length=n)).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["chirp", "noise", "burst", "multitone"])
def test_default_allocator_quality_not_below_gold(name):
    """The encode contract: round-trip PSNR >= the reference encoder's, zero
    slack, on the signals of tests/test_true_rdo.py; and the bit budget."""
    x = frames(_rdo_signals()[name])
    fd_gold, _ = gold_encode_frames(x)
    fd, _ = port.encode_frames(x, device=CPU)
    wl = fd.word_lengths.numpy()
    assert (_used_bits(wl) + 40 + 10 * 52 <= 1696).all() and (wl >= 0).all() and (wl <= 15).all()
    p_port, p_gold = _psnr_vs_source(x, _jax_fd(fd)), _psnr_vs_source(x, fd_gold)
    assert p_port >= p_gold, (name, p_port, p_gold)


def test_encoder_on_fixture_classes_matches_gold():
    """The six encode-quality classes of the fixture that chip_smoke.py holds
    the card to: block modes equal the gold engine's; scale factors too,
    except one-off indices where the peak rounds across a table value (the
    JAX encoder's differ in such places as well: 8, 1 and 2 BFUs); PSNR
    through the port's own exact decoder >= gold's."""
    expect = np.load(os.path.join(FIXTURES, "torch_encode_expect.npz"))
    for name, sig in testing.signals(float(expect["seconds"])).items():
        x = pcm_to_frames(sig)
        fd, _ = port.encode_frames(x, port.EncoderOptions(allocator="reference"), device=CPU)
        assert np.array_equal(fd.block_modes.numpy(), expect[f"{name}/block_modes"]), name
        bfu, _, _, _ = port.pipeline.encoder.analysis_step(_t(x), port.encoder_init_state(CPU), (1.0,) * 3)
        peaks = torch.where(_t(C.BFU_SLOT_MASK), bfu.abs(), 0.0).amax(dim=-1).numpy()
        sf = fd.scale_factors.numpy()
        assert testing.scale_factor_faults(sf, expect[f"{name}/scale_factors"], peaks) == 0, name
        assert (sf != expect[f"{name}/scale_factors"]).sum() <= 8, name
        units = port.encode_pcm(sig[None], device=CPU)
        out = port.decode_units(units, 1, device=CPU).numpy().reshape(-1)
        assert testing.psnr(sig, out) >= float(expect[f"{name}/psnr_gold"]), name


def test_encode_state_carries_across_chunks_and_engines():
    """Chunked == whole at the JAX suite's tolerance (tests/test_tpu_engine.py
    test_tpu_stream_chunking_consistent: modes and scale factors equal,
    quantized off by at most 1 on under 1e-3 of the values), within the
    port, and with the stream handed port -> JAX -> port through NumPy."""
    x = _signal(8, seed=21)
    whole, _ = port.encode_frames(x, device=CPU)
    whole = convert.framedata_to_numpy(whole)

    def check(parts):
        for k in ("block_modes", "scale_factors"):
            assert np.array_equal(np.concatenate([p[k] for p in parts]), whole[k]), k
        qdiff = np.abs(np.concatenate([p["quantized"] for p in parts]) - whole["quantized"])
        assert qdiff.max() <= 1 and (qdiff != 0).mean() < 1e-3

    state, parts = None, []
    for s, e in ((0, 3), (3, 5), (5, 8)):
        fd, state = port.encode_frames(x[s:e], state=state, device=CPU)
        parts.append(convert.framedata_to_numpy(fd))
    check(parts)

    fd_a, state = port.encode_frames(x[0:3], device=CPU)
    fd_b, jstate = jax_encode_frames(x[3:5], state={k: jnp.asarray(v) for k, v in convert.state_to_numpy(state).items()})
    fd_c, _ = port.encode_frames(x[5:8], state=convert.state_from_numpy(jstate, CPU), device=CPU)
    fd_b = fd_b.to_numpy()
    check([convert.framedata_to_numpy(fd_a), {k: getattr(fd_b, k) for k in JaxFrameData.fields()},
           convert.framedata_to_numpy(fd_c)])


def test_encode_pcm_round_trip_and_int16_input():
    n = 21 * 512 + 100                                             # a ragged tail, three chunks
    t = np.arange(n) / 44100.0
    left = (0.6 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    right = (0.3 * np.sin(2 * np.pi * 1000 * t) + 0.1 * white_noise(3, n)).astype(np.float32)
    i16 = np.stack([jax_wav.float_to_int16(left), jax_wav.float_to_int16(right)])
    f32 = jax_wav.int16_to_float(i16)
    units = port.encode_pcm(f32, device=CPU, chunk_frames=8)
    assert units.dtype == np.uint8 and units.shape == (2 * 22, 212)
    # raw int16 samples, converted on the device, give the same bytes
    assert np.array_equal(port.encode_pcm(i16, device=CPU, chunk_frames=8), units)
    dev16, _ = _encode_batch_dev(_t(np.stack([pcm_to_frames(c) for c in i16])), port.EncoderOptions(), None)
    dev32, _ = _encode_batch_dev(_t(np.stack([pcm_to_frames(c) for c in f32])), port.EncoderOptions(), None)
    assert dev16.dtype == torch.uint8 and torch.equal(dev16, dev32)
    for ch, src in enumerate(f32):
        out, _ = gold_decode_frames(unpack_frames_fast(units[ch::2]))
        x = src[: n - C.CODEC_DELAY].astype(np.float64)
        y = out.reshape(-1)[C.CODEC_DELAY: n].astype(np.float64)
        assert 10 * np.log10(np.mean(x**2) / np.mean((x - y) ** 2)) > (50, 20)[ch], ch   # a tone; a tone in noise
    mono = port.encode_pcm(f32[:1], device=CPU)
    assert mono.shape == (22, 212)
    with pytest.raises(ValueError):
        port.encode_pcm(np.zeros((3, 512), np.float32), device=CPU)


def test_encode_zero_frames_and_shapes():
    fd, state = port.encode_frames(np.zeros((0, 512), np.float32), device=CPU)
    assert fd.num_frames == 0 and fd.quantized.shape == (0, 52, 20)
    assert sorted(state) == sorted(gold_init_state())
    for k, v in gold_init_state().items():
        assert tuple(state[k].shape) == v.shape, k
    assert port.encoder_init_state(CPU, 2)["band_tail0"].shape == (2, 32)
    with pytest.raises(ValueError):
        port.encode_frames(np.zeros((4, 100), np.float32), device=CPU)


@pytest.mark.parametrize(
    "call",
    [
        lambda: port.encode_frames(np.zeros((2, 512), np.float32)),
        lambda: port.encode_pcm(np.zeros((1, 1024), np.float32)),
        lambda: port.encoder_init_state(),
        lambda: port.encode_step(torch.zeros(2, 512), port.encoder_init_state("cuda"), (1.0,) * 3, 1.0),
    ],
)
def test_encode_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        call()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, carta1_tpu_torch, carta1_tpu_torch.testing, carta1_tpu_torch.convert\n"
        "from carta1_tpu_torch.ops import bitalloc, bitalloc_kernels, bitpack, coding, mdct, qmf, transient\n"
        "from carta1_tpu_torch import cli, processor, profiling\n"
        "from carta1_tpu_torch.io import aea, streams, wav\n"
        "assert 'jax' not in sys.modules and 'carta1_tpu' not in sys.modules\n"
        "assert set(carta1_tpu_torch.__all__) >= {'EncoderOptions', 'encode_frames', 'encode_step', "
        "'encoder_init_state', 'encode_pcm', 'encode_file', 'decode_file', 'encode_clips'}\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


def test_testing_signals_are_the_reference_scripts_signals():
    sys.path.insert(0, ROOT)
    try:
        import bench
        import quality_report
    finally:
        sys.path.remove(ROOT)
    want, got = quality_report.signals(1.0), testing.signals(1.0)
    assert list(want) == list(got)
    for k in want:
        assert _same_bits(got[k], want[k]), k
    assert _same_bits(testing.synth_audio(40, 2), bench.synth_audio(40, 2))
    x, y = got["chirp"], got["chirp"] + np.float32(1e-3)
    assert testing.psnr(x, y) == quality_report.psnr(x, y)
