"""The port's gold surface against `carta1_tpu.gold`, bit for bit, on the CPU.

The reference's transform and coding layers with gold's signatures
(`carta1_tpu_torch/gold/transforms.py`, `gold/coding.py`): the MDCT and
IMDCT of sizes 64 / 256 / 512 at the reference's instance scales and at
gold's default and other scales, the overlap-add, the whole-stream QMF
synthesis (odd lengths, and chained with the delay carried), the
dequantizer, the scale factors with a slot mask, the heap allocator and
the sorted sweep at biases 0.7 / 1.0 / 2.0; the constants the port copies
word for word; and the `on_progress` calls of `encode_pcm` /
`decode_units`.  Seeded NumPy inputs; the kernels' plain versions run
(CPU tensors).  `carta1_tpu.gold` is NumPy: nothing here compiles a JAX
function.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import carta1_tpu
from carta1_tpu import constants as jax_constants
from carta1_tpu.gold import coding as jax_coding
from carta1_tpu.gold import transforms as jax_transforms
from carta1_tpu.ops import tables as jax_tables

import carta1_tpu_torch as port
from carta1_tpu_torch import constants, decode_units, encode_pcm, tables, testing
from carta1_tpu_torch.gold import coding, transforms
from carta1_tpu_torch.ops import fftjs_kernels, imdct_kernels

SIZES = (64, 256, 512)
BIASES = (0.7, 1.0, 2.0)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(got: torch.Tensor, want: np.ndarray) -> bool:
    """Bitwise equal, f32 compared as words (so -0 and +0 differ)."""
    g = got.numpy()
    if g.dtype != want.dtype or g.shape != want.shape:
        return False
    if g.dtype == np.float32:
        return np.array_equal(g.view(np.int32), want.view(np.int32))
    return np.array_equal(g, want)


def _signal(rows: int, cols: int, seed: int) -> np.ndarray:
    """f32 [rows, cols]: noise over 12 binades, a silent row, a row of -0,
    denormals and a full-scale row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)) * np.exp2(rng.integers(-12, 1, (rows, 1)))
    edits = (lambda r: 0.0, lambda r: -0.0, lambda r: np.where(np.arange(cols) % 3, r, 1e-40), np.sign)
    for i, edit in enumerate(edits[:rows]):
        x[i] = edit(x[i])
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES)
def test_mdct_js_at_instance_and_other_scales_equals_gold(size):
    x = _signal(9, size, size)
    for scale in (transforms.MDCT_SCALES[size], float(size), 3.0):
        want = jax_transforms.mdct_js(x, size, scale)
        assert _same(transforms.mdct_js(_t(x), size, scale), want), scale
        assert _same(fftjs_kernels.mdct_js(_t(x), size, scale), want), scale      # K6's wrapper
    want = jax_transforms.mdct(x.reshape(3, 3, size), size)
    assert _same(transforms.mdct(_t(x).reshape(3, 3, size), size), want)


@pytest.mark.parametrize("size", SIZES)
def test_imdct_js_at_instance_and_default_scales_equals_gold(size):
    x = _signal(9, size // 2, size + 1)
    for scale in (None, transforms.IMDCT_SCALES[size], 7.0):
        want = jax_transforms.imdct_js(x, size, scale)
        assert _same(transforms.imdct_js(_t(x), size, scale), want), scale
        # K1's wrapper computes the middle half
        mid = imdct_kernels.imdct_mid(_t(x), size, float(size) if scale is None else scale)
        assert _same(mid, want[:, size // 4: 3 * size // 4]), scale
    want = jax_transforms.imdct(x.reshape(3, 3, size // 2), size)
    assert _same(transforms.imdct(_t(x).reshape(3, 3, size // 2), size), want)


def test_scale_tables_are_cached_by_size_and_scale():
    assert tables.imdct_tables(256) is tables.imdct_tables(256, 2048.0)
    assert tables.mdct_tables(512) is tables.mdct_tables(512, 1.0)
    assert tables.imdct_tables(512, 512.0) is not tables.imdct_tables(512)
    assert transforms.MDCT_SCALES == jax_transforms.MDCT_SCALES
    assert transforms.IMDCT_SCALES == jax_transforms.IMDCT_SCALES


@pytest.mark.parametrize("size", SIZES)
def test_bases_equal_gold(size):
    assert np.array_equal(transforms.mdct_basis(size), jax_transforms.mdct_basis(size))
    assert np.array_equal(transforms.imdct_basis(size), jax_transforms.imdct_basis(size))


def test_transforms_refuse_other_dtypes_and_sizes():
    with pytest.raises(ValueError, match="f32"):
        transforms.mdct_js(torch.zeros(2, 256, dtype=torch.float64), 256, 0.5)
    with pytest.raises(ValueError, match="f32"):
        transforms.imdct_js(torch.zeros(2, 128, dtype=torch.float64), 256)
    with pytest.raises(ValueError, match="size"):
        transforms.mdct_js(torch.zeros(2, 128), 128, 0.5)
    with pytest.raises(ValueError, match="size"):
        transforms.imdct(torch.zeros(2, 64), 128)
    with pytest.raises(ValueError, match="f32"):
        transforms.qmf_synthesis_stream(*(torch.zeros(1, 8, dtype=torch.float16),) * 2, torch.zeros(1, 46))


@pytest.mark.parametrize("n", [16, 9])
def test_overlap_add_js_equals_gold(n):
    prev, curr = _signal(12, n, 3 + n), _signal(12, n, 4 + n)[::-1].copy()
    assert _same(transforms.overlap_add_js(_t(prev), _t(curr)), jax_transforms.overlap_add_js(prev, curr))


@pytest.mark.parametrize("s", [3 * 128, 5 * 256 + 128, 7, 20])
def test_qmf_synthesis_stream_equals_gold(s):
    """Odd frame counts (3 low bands, 5.5 high bands) and streams shorter
    than a row and than the delay; two channels."""
    rng = np.random.default_rng(s)
    low, high = _signal(2, s, s), _signal(2, s, s + 1)
    delay = (rng.standard_normal((2, 46)) * 0.1).astype(np.float32)
    want_out, want_delay = jax_transforms.qmf_synthesis_stream(low, high, delay)
    got_out, got_delay = transforms.qmf_synthesis_stream(_t(low), _t(high), _t(delay))
    assert _same(got_out, want_out) and _same(got_delay, want_delay)


def test_qmf_synthesis_stream_chained_equals_one_call():
    s = 3 * 256
    low, high = _signal(2, s, 11), _signal(2, s, 12)
    delay = torch.zeros(2, 46)
    one, one_delay = transforms.qmf_synthesis_stream(_t(low), _t(high), delay)
    parts, d = [], delay
    for a, b in ((0, 100), (100, 356), (356, s)):
        out, d = transforms.qmf_synthesis_stream(_t(low[:, a:b]), _t(high[:, a:b]), d)
        parts.append(out)
    assert torch.equal(torch.cat(parts, dim=-1).view(torch.int32), one.view(torch.int32))
    assert torch.equal(d, one_delay)
    want, _ = jax_transforms.qmf_synthesis_stream(low, high, np.zeros((2, 46), np.float32))
    assert _same(one, want)


# ---------------------------------------------------------------------------
# coding
# ---------------------------------------------------------------------------
def test_dequantize_js_equals_gold():
    rng = np.random.default_rng(21)
    wl = rng.integers(0, 16, (30, 52)).astype(np.int32)
    sf = rng.integers(0, 64, (30, 52)).astype(np.int32)
    hi = (1 << np.maximum(constants.WORD_LENGTH_BITS[wl] - 1, 0)) - 1
    q = (rng.integers(-(1 << 15), 1 << 15, (30, 52, 20)) % (2 * hi[..., None] + 1) - hi[..., None]).astype(np.int32)
    want = jax_coding.dequantize_js(q, sf, wl)
    assert _same(coding.dequantize_js(_t(q), _t(sf), _t(wl)), want)


def test_find_scale_factors_with_a_slot_mask_equals_gold():
    rng = np.random.default_rng(22)
    bfu = np.concatenate([testing.alloc_inputs(kind, 6, 40 + i)[0] for i, kind in enumerate(testing.ALLOC_KINDS)])
    # peaks on and one ulp around every table value
    v = constants.SCALE_FACTORS.astype(np.float32)
    bfu[:3, :, 0] = np.stack([np.nextafter(v, 0), v, np.nextafter(v, 1)])[:, 12:64]
    for mask in (constants.BFU_SLOT_MASK, rng.random((bfu.shape[0], 52, 20)) < 0.5, np.ones(20, bool)):
        want = jax_coding.find_scale_factors(bfu, mask)
        assert np.array_equal(coding.find_scale_factors(_t(bfu), mask).numpy(), want)
        assert np.array_equal(coding.find_scale_factors(_t(bfu), torch.from_numpy(np.array(mask))).numpy(), want)


def _alloc_data() -> np.ndarray:
    """f32 [F, 52, 20]: the BFU data of every kind of `testing.alloc_inputs`
    (random, exact ties, NaN and inf, denormals, sparse, ...), 6 frames each,
    then data whose gold scale factors are each kind's (silent frames, all
    63, exact ties)."""
    inputs = [testing.alloc_inputs(kind, 6, 60 + i) for i, kind in enumerate(testing.ALLOC_KINDS)]
    return np.concatenate([b for b, _ in inputs] + [testing.heap_edge_peaks(s) for _, s in inputs])


@pytest.mark.parametrize("bias", BIASES)
def test_allocate_bits_equals_gold_heap(bias):
    bfu = _alloc_data()
    want_wl, want_sf = jax_coding.allocate_bits(bfu, jax_constants.SPECS_PER_BFU, bias)
    got_wl, got_sf = coding.allocate_bits(_t(bfu), constants.SPECS_PER_BFU, bias)
    assert np.array_equal(got_sf.numpy(), want_sf) and np.array_equal(got_wl.numpy(), want_wl)
    assert (want_sf == 0).all(axis=1).any() and (want_sf == 63).all(axis=1).any()     # silent and all-63 frames
    for f in (0, 20, 30, 45, 70):
        wl, sf = coding.allocate_bits_frame(_t(bfu[f]), torch.from_numpy(constants.SPECS_PER_BFU), bias)
        want = jax_coding.allocate_bits_frame(bfu[f], jax_constants.SPECS_PER_BFU, bias)
        assert np.array_equal(wl.numpy(), want[0]) and np.array_equal(sf.numpy(), want[1])


@pytest.mark.parametrize("bias", BIASES)
def test_allocate_bits_sweep_equals_gold_sweep(bias):
    """Gold's sorted-sweep spec against kernel K4's `alloc_reference` (its
    plain version), frame for frame."""
    sf = np.concatenate([testing.alloc_inputs(kind, 8, 80 + i)[1] for i, kind in enumerate(testing.ALLOC_KINDS)])
    want = jax_coding.allocate_bits_sweep(sf, jax_constants.SPECS_PER_BFU, bias)
    got = coding.allocate_bits_sweep(_t(sf), constants.SPECS_PER_BFU, bias).numpy()
    differ = np.flatnonzero((got != want).any(axis=1))
    assert differ.size == 0, f"frames {differ.tolist()} differ from gold's sweep"


def test_allocators_refuse_other_bfu_sizes():
    sizes = constants.SPECS_PER_BFU.copy()
    sizes[3] = 5
    with pytest.raises(ValueError, match="BFU sizes"):
        coding.allocate_bits(torch.zeros(2, 52, 20), sizes, 1.0)
    with pytest.raises(ValueError, match="BFU sizes"):
        coding.allocate_bits_sweep(torch.zeros(2, 52, dtype=torch.int32), sizes[:40], 1.0)


# ---------------------------------------------------------------------------
# constants and package-level names
# ---------------------------------------------------------------------------
def _upper(module) -> dict:
    return {k: v for k, v in vars(module).items() if k.isupper() and not k.startswith("_")}


def _equal_words(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def test_constants_equal_the_jax_package_word_for_word():
    jax_c = _upper(jax_constants)
    missing = sorted(set(jax_c) - set(_upper(constants)))
    assert not missing, missing
    differ = [k for k, v in jax_c.items() if not _equal_words(getattr(constants, k), v)]
    assert not differ, differ
    for name in ("DEQUANT_STEP", "QUANT_NORM", "QUANT_RANGES", "RDO_STEP_GAIN", "RDO_STEP_BITS", "RDO_CAND_BFU",
                 "RDO_CAND_WL", "RDO_CAND_COST", "RDO_BUDGET"):
        assert _equal_words(getattr(tables, name), getattr(jax_tables, name)), name


def test_package_level_names_equal_the_jax_package():
    for name in ("SAMPLE_RATE", "SAMPLES_PER_FRAME", "SOUND_UNIT_SIZE", "CODEC_DELAY", "__version__"):
        assert getattr(port, name) == getattr(carta1_tpu, name), name
        assert name in port.__all__


# ---------------------------------------------------------------------------
# on_progress
# ---------------------------------------------------------------------------
# the JAX package's calls, (min(start + chunk_frames, n), n) once per chunk
# (carta1_tpu/processor.py encode_pcm / decode_units), written out
ENCODE_CALLS = {3: [(3, 10), (6, 10), (9, 10), (10, 10)], 4: [(4, 10), (8, 10), (10, 10)], 10: [(10, 10)],
                16: [(10, 10)]}
DECODE_CALLS = {4: [(4, 10), (8, 10), (10, 10)], 10: [(10, 10)], 3: [(3, 10), (6, 10), (9, 10), (10, 10)]}


@pytest.fixture(scope="module")
def stereo_units() -> tuple[np.ndarray, np.ndarray]:
    pcm = testing.synth_audio(10, 2)[:, : 10 * 512 - 100]                # 10 frames per channel
    return pcm, encode_pcm(pcm, device="cpu")


def test_encode_pcm_on_progress_calls(stereo_units):
    pcm, units = stereo_units
    for chunk, want in ENCODE_CALLS.items():
        calls = []
        got = encode_pcm(pcm, device="cpu", chunk_frames=chunk, on_progress=lambda d, n: calls.append((d, n)))
        assert calls == want, chunk
        assert np.array_equal(got, units), chunk
    calls = []
    encode_pcm(pcm[:1], device="cpu", chunk_frames=4, engine="exact", on_progress=lambda d, n: calls.append((d, n)))
    assert calls == ENCODE_CALLS[4]


def test_decode_units_on_progress_calls(stereo_units):
    _, units = stereo_units
    odd = units[:19]                             # 19 stereo units: padded with a silent unit, 10 frames
    whole = decode_units(odd, 2, device="cpu")
    for chunk, want in DECODE_CALLS.items():
        calls = []
        got = decode_units(odd, 2, device="cpu", chunk_frames=chunk, on_progress=lambda d, n: calls.append((d, n)))
        assert calls == want, chunk
        assert torch.equal(got, whole), chunk
    calls = []
    decode_units(units[:10], 1, device="cpu", chunk_frames=4, engine="exact",
                 on_progress=lambda d, n: calls.append((d, n)))
    assert calls == ENCODE_CALLS[4]
