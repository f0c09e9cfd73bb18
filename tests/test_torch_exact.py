"""The port's exact engine (`engine="exact"`) against the JAX package's gold engine, on the CPU.

Every module of `carta1_tpu_torch/gold/` is held to `carta1_tpu.gold`
(NumPy: nothing here compiles a JAX program): the transforms f32-bitwise,
the transient score within rtol 1e-12 with block modes exact, the heap
allocator (K5's plain version) and the quantizer exactly, and the
encoder's FrameData field for field, its units byte for byte, down to
`tests/fixtures/golden.aea`.  The entry points with `engine="exact"` are
held to the JAX package's exact engine: `encode_pcm`, `encode_file` (with a
checkpoint from either package), `decode_file`, both CLIs and
`transcode_corpus`.  `tests/fixtures/torch_exact_expect.npz` (inputs and gold's units,
`tools/make_torch_exact_fixture.py`) is checked here against its sources;
chip_smoke.py phase 11 holds the card to it.  K5 and K6 themselves run on
the card only: tests/test_torch_kernels_cuda.py.
"""

import ast
import os

import numpy as np
import pytest
import torch

from carta1_tpu import cli as jax_cli
from carta1_tpu import processor as jax_processor
from carta1_tpu.constants import INV_POWER_OF_TWO as JAX_INV2
from carta1_tpu.constants import SCALE_FACTORS as JAX_SF
from carta1_tpu.constants import SPECS_PER_BFU as JAX_SPECS
from carta1_tpu.constants import WORD_LENGTH_BITS as JAX_WLB
from carta1_tpu.gold import coding as jax_coding
from carta1_tpu.gold import encoder as jax_encoder
from carta1_tpu.gold import fftjs as jax_fftjs
from carta1_tpu.gold import gold_decode_frames as jax_gold_decode
from carta1_tpu.gold import transforms as jax_transforms
from carta1_tpu.gold import transient as jax_transient
from carta1_tpu.io import aea as jax_aea
from carta1_tpu.io import wav as jax_wav
from carta1_tpu.io.bitstream_np import pack_frames as jax_pack
from carta1_tpu.io.bitstream_np import unpack_frames as jax_unpack
from carta1_tpu.options import EncoderOptions as JaxOptions

import carta1_tpu_torch as port
from carta1_tpu_torch import EncoderOptions, cli, testing
from carta1_tpu_torch.gold import coding, encoder, fftjs, transforms, transient
from carta1_tpu_torch.io import streams, wav
from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops import fftjs_kernels, heap_kernels, qmf_kernels
from carta1_tpu_torch.ops.bitpack import pack_frames
from carta1_tpu_torch.ops.coding import group_bfus
from carta1_tpu_torch.ops.pcm import float_to_int16
from carta1_tpu_torch.parallel import multihost
from carta1_tpu_torch.tables import RDO_BUDGET, fft_tables, heap_priority_table, heap_rank_table, mdct_tables

from test_golden import _golden_signal
from test_torch_files import _KillAt

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GOLD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "carta1_tpu_torch", "gold")
CHUNK = 8
EXPECT = testing.exact_expect(os.path.join(FIXTURES, "torch_exact_expect.npz"))
CLASSES = tuple(testing.signals(1.0))


@pytest.fixture(autouse=True, scope="module")
def _no_native_build():
    """The JAX package's host packers in NumPy: no C++ build on first use."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CARTA1_NO_NATIVE", "1")
        yield


def _same(a, b) -> bool:
    """Bitwise equal arrays (f32 compared as their words)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a, b)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))                         # a writable copy


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _rows(rows: int, cols: int, seed: int) -> np.ndarray:
    """`testing.edge_rows` (zeros of both signs, denormals, lone and huge
    samples) followed by ordinary random rows."""
    rng = np.random.default_rng(seed)
    rand = (rng.standard_normal((rows, cols)) * np.exp2(rng.integers(-10, 4, (rows, cols)))).astype(np.float32)
    return np.concatenate([testing.edge_rows(rows, cols, seed, 1e30), rand])


def _assert_fd_equal(got, want) -> None:
    for k in ("n_bfu", "block_modes", "scale_factors", "word_lengths", "quantized"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k


# ---------------------------------------------------------------------------
# the modules, one by one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 64, 128, 256])
def test_fft_js_bitwise_gold(n):
    re, im = _rows(19, n, n), _rows(19, n, n + 1)
    want = jax_fftjs.fft_js(re, im)
    got = fftjs.fft_js(_t(re), _t(im))
    assert _same(got[0].numpy(), want[0]) and _same(got[1].numpy(), want[1])


@pytest.mark.parametrize("size", [64, 256, 512])
def test_mdct_js_bitwise_gold(size):
    x = _rows(19, size, size)
    assert _same(transforms.mdct(_t(x), size).numpy(), jax_transforms.mdct(x, size))


@pytest.mark.parametrize("fft_size,length", [(128, 128), (256, 256), (128, 100), (256, 300)])
def test_magnitude_spectrum_js_bitwise_gold(fft_size, length):
    """Zero padding and cutting included."""
    x = _rows(19, length, fft_size + length)
    want = jax_fftjs.magnitude_spectrum_js(x, fft_size)
    assert _same(fftjs.magnitude_spectrum_js(_t(x), fft_size).numpy(), want)


def test_qmf_analysis_stream_bitwise_gold():
    rng = np.random.default_rng(3)
    signal = np.concatenate([testing.edge_rows(4, 512, 9, 1e30).reshape(-1),
                             (rng.standard_normal(5 * 512) * 0.5).astype(np.float32)])
    delay = rng.standard_normal(46).astype(np.float32)
    want = jax_transforms.qmf_analysis_stream(signal, delay)
    got = transforms.qmf_analysis_stream(_t(signal), _t(delay))
    assert all(_same(g.numpy(), w) for g, w in zip(got, want))
    got = transforms.qmf_analysis_stream(_t(signal), _t(delay), plain=True)
    assert all(_same(g.numpy(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [0, 1, 7, 45, 46, 47, 2 * 1025 + 1])
def test_qmf_analysis_stream_lengths_bitwise_gold(n):
    """Rows of every length K8's wrapper takes: odd N (the last sample only
    enters the delay), N shorter than the delay, N < 2 (no output); three
    rows, each behind a delay of its own; with and without `plain`."""
    signal, delay = testing.qmf_analysis_edge_inputs(3, n, n)
    with np.errstate(over="ignore", invalid="ignore"):                    # inf and NaN are inputs here
        want = [np.stack(w) for w in zip(*(jax_transforms.qmf_analysis_stream(s, d) for s, d in zip(signal, delay)))]
    for plain in (False, True):
        got = transforms.qmf_analysis_stream(_t(signal), _t(delay), plain=plain)
        assert all(_same(g.numpy(), w) for g, w in zip(got, want)), plain


def test_qmf_analysis_stream_chunks_equal_one_call():
    """A stream cut into chunks of even lengths (one shorter than the delay)
    gives the whole stream's bands and new delay; zero rows give empty
    bands."""
    rng = np.random.default_rng(8)
    signal = (rng.standard_normal((2, 3 * 512 + 40)) * 0.3).astype(np.float32)
    delay = (rng.standard_normal((2, 46)) * 0.1).astype(np.float32)
    low, high, last = transforms.qmf_analysis_stream(_t(signal), _t(delay))
    parts, d = [], _t(delay)
    for a, b in ((0, 20), (20, 532), (532, signal.shape[1])):
        lo, hi, d = transforms.qmf_analysis_stream(_t(signal[:, a:b]), d)
        parts.append((lo, hi))
    assert _same(torch.cat([p[0] for p in parts], dim=-1).numpy(), low.numpy())
    assert _same(torch.cat([p[1] for p in parts], dim=-1).numpy(), high.numpy())
    assert _same(d.numpy(), last.numpy())
    empty = transforms.qmf_analysis_stream(torch.zeros(0, 512), torch.zeros(0, 46))
    assert [tuple(t.shape) for t in empty] == [(0, 256), (0, 256), (0, 46)]


def _k8_emulation(signal: np.ndarray, delay: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K8's thread-to-data map (`csrc/qmf_analysis.cu`), emulated with its
    f64 operations as PyTorch ops on the CPU (NumPy's adds keep other NaN
    words where two NaNs meet): every block's padded tile filled from
    [delay | signal] (NaN where the kernel copies nothing), each thread's
    walk over its window from the last sample pair down, the bands written
    through the tile (each slot once) and stored.  Returns (low, high)
    [B, N // 2]."""
    threads, pairs, taps = qmf_kernels.THREADS, qmf_kernels.PAIRS, 24
    batch, n = signal.shape
    n_out = n // 2
    low, high = np.full((batch, n_out), np.nan, np.float32), np.full((batch, n_out), np.nan, np.float32)
    tile_rows, tile_pairs = qmf_kernels.analysis_tile(n)
    segs = tile_pairs // pairs
    padded = lambda k: 2 * k + 2 * (k // pairs)                          # noqa: E731
    row_len = padded(tile_pairs + taps - 1)
    row_len += 0 if (row_len // 2) % 2 else 2
    half = tile_pairs + segs
    assert 2 * half <= row_len and tile_rows * row_len * 4 <= 36 * 1024
    work = np.concatenate([delay, signal], axis=1)
    even_t, odd_t = C.QMF_EVEN.astype(np.float64).tolist(), C.QMF_ODD.astype(np.float64).tolist()
    for b0 in range(0, batch, tile_rows):
        for c0 in range(0, n_out, tile_pairs):
            rows, cols = min(tile_rows, batch - b0), min(tile_pairs, n_out - c0)
            tile = np.full((tile_rows, row_len), np.nan, np.float32)
            k = np.arange(2 * (cols + taps - 1))
            tile[:rows, padded(k >> 1) + (k & 1)] = work[b0:b0 + rows, 2 * c0 + k]
            t = np.arange(threads)
            r, seg = t // segs, t % segs
            active = (r < rows) & (seg * pairs < cols)
            r, base = r[active], padded(seg[active] * pairs)
            even = torch.zeros((pairs, r.size), dtype=torch.float64)
            odd = torch.zeros_like(even)
            for m in range(pairs + taps - 2, -1, -1):
                o = torch.from_numpy(tile[r, base + padded(m)]).double()
                e = torch.from_numpy(tile[r, base + padded(m) + 1]).double()
                for p in range(pairs):
                    j = taps - 1 + p - m
                    if 0 <= j < taps:
                        even[p] = even[p] + e * even_t[j]
                        odd[p] = odd[p] + o * odd_t[j]
            written = np.zeros((tile_rows, row_len), int)
            out_at = seg[active] * pairs + seg[active]                          # padded_out(seg * pairs)
            for p in range(pairs):
                np.add.at(written, (r, out_at + p), 1)
                np.add.at(written, (r, out_at + half + p), 1)
                tile[r, out_at + p] = (even[p] + odd[p]).float().numpy()
                tile[r, out_at + half + p] = (even[p] - odd[p]).float().numpy()
            assert written.max() <= 1
            kk = np.arange(cols)
            at = kk + kk // pairs
            low[b0:b0 + rows, c0:c0 + cols] = tile[:rows, at]
            high[b0:b0 + rows, c0:c0 + cols] = tile[:rows, at + half]
    return low, high


@pytest.mark.parametrize("n", [1, 6, 45, 47, 300, 2 * 1030 + 1, 2 * 2200])
def test_qmf_analysis_kernel_emulation_equals_plain(n):
    """K8's map on batches around a block's rows (1, 2, one short of a
    block, one over, several blocks) and widths of one thread's run, short
    of the delay, a ragged last tile and more than one column tile: the
    plain version's bands, word for word; every slot of the tile that an
    output reads was copied."""
    tile_rows, _ = qmf_kernels.analysis_tile(n)
    for batch in sorted({1, 2, max(tile_rows - 1, 1), tile_rows + 1, 2 * tile_rows + 3}):
        signal, delay = testing.qmf_analysis_edge_inputs(batch, n, n + batch)
        low, high = _k8_emulation(signal, delay)
        want = qmf_kernels.qmf_analysis_taps_plain(_t(signal), _t(delay))
        assert _same(low, want[0].numpy()) and _same(high, want[1].numpy()), batch


def test_qmf_analysis_taps_rejects_bad_inputs():
    """K8's wrapper takes f32 [B, N] and [B, 46], contiguous, one device."""
    bad = [
        (torch.zeros(2, 64, dtype=torch.float64), torch.zeros(2, 46, dtype=torch.float64)),
        (torch.zeros(2, 64), torch.zeros(2, 45)),
        (torch.zeros(2, 64), torch.zeros(3, 46)),
        (torch.zeros(64, 2).T, torch.zeros(2, 46)),
        (torch.zeros(2, 64), torch.zeros(46, 2).T),
        (torch.zeros(64), torch.zeros(46)),
    ]
    for signal, delay in bad:
        with pytest.raises(ValueError):
            qmf_kernels.qmf_analysis_taps(signal, delay)
    with pytest.raises(ValueError, match="f32"):
        transforms.qmf_analysis_stream(torch.zeros(2, 64, dtype=torch.float64), torch.zeros(2, 46))
    with pytest.raises(ValueError, match="delay"):
        transforms.qmf_analysis_stream(torch.zeros(2, 64), torch.zeros(2, 40))


def test_transient_score_within_rtol_and_modes_exact():
    """Spectra of real bands (where the modes switch) and of random rows
    with silent and nearly silent bins."""
    frames = EXPECT["inputs"]["transients"]
    bands, _ = jax_encoder._analysis_bands(frames, jax_encoder.encoder_init_state())
    rng = np.random.default_rng(4)
    rand = np.abs(rng.standard_normal((40, 128))).astype(np.float32)
    rand[3], rand[5, :40], rand[7, ::2] = 0.0, 1e-12, 1e-11
    for b, n in enumerate((128, 128, 256)):
        spec = jax_fftjs.magnitude_spectrum_js(bands[b], n)
        cases = [(spec[1:], spec[:-1]), (rand[:, : n // 2], rand[::-1, : n // 2])]
        for cur, prev in cases:
            want = jax_transient.transient_score(cur, prev)
            got = transient.transient_score(_t(cur), _t(prev)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            assert np.array_equal(got > 1.0, want > 1.0)


def test_heap_priority_table_is_gold_priority():
    """The host table equals the priority gold computes inside
    allocate_bits_frame, read back through a one-BFU heap: equal tables
    give equal allocations (held below); here the formula, term by term."""
    for bias in (0.7, 1.0, 2.0):
        tab = heap_priority_table(bias)
        for sf in (1, 17, 40, 63):
            eff = JAX_SF[sf] ** bias
            b1, b2 = 0, int(JAX_WLB[1])
            assert tab[sf, 0] == eff * (2.0 - JAX_INV2[b2]) / (b2 - b1)
            b1, b2 = int(JAX_WLB[5]), int(JAX_WLB[6])
            assert tab[sf, 5] == eff * (JAX_INV2[b1] - JAX_INV2[b2]) / (b2 - b1)


@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_heap_allocator_equals_gold(bias):
    """K5's plain version on every K5 edge input at the codec's budget
    (exact ties, silent, all 63, sparse, heaps of 0, 1, 2 and 52 entries,
    a BFU at the top word length), as BFU data whose gold scale factors are
    those of the case; some frame spends the budget to the last bit."""
    spent_all = 0
    for name, sf, budget in testing.heap_edge_cases(heap_kernels.BLOCK_FRAMES):
        if budget != RDO_BUDGET:
            continue
        want_wl, want_sf = jax_coding.allocate_bits(testing.heap_edge_peaks(sf), JAX_SPECS, bias)
        assert np.array_equal(want_sf, sf), name
        got = coding.allocate_bits_sf(_t(sf), bias).numpy()
        assert np.array_equal(got, want_wl), name
        used = (JAX_WLB[got] * JAX_SPECS).sum(axis=1)
        spent_all += int((used == RDO_BUDGET).sum())
        assert (used <= RDO_BUDGET).all()
    assert spent_all > 0


def test_heap_budgets_run_out_where_they_should():
    """The eight 8-slot BFUs need 1024 bits to reach the top word length:
    at 1023 one step is missing, at 1024 and 1025 none; 0 bits allocate
    nothing."""
    cases = {b: sf for name, sf, b in testing.heap_edge_cases(heap_kernels.BLOCK_FRAMES) if "eight" in name}
    steps = {b: heap_kernels.alloc_heap_plain(_t(sf), 1.0, budget=b).numpy().sum(axis=1) for b, sf in cases.items()}
    assert (steps[1024] == 8 * 15).all() and (steps[1025] == 8 * 15).all() and (steps[1023] == 8 * 15 - 1).all()
    assert (steps[0] == 0).all() and (steps[1] == 0).all() and (steps[2] == 0).all()


def test_quantize_js_equals_gold():
    rng = np.random.default_rng(6)
    coeffs = (rng.standard_normal((40, 52, 20)) * np.exp2(rng.integers(-12, 1, (40, 52, 1)))).astype(np.float32)
    coeffs[0, :, 0] = np.float32(JAX_SF[30])          # the clamp at full range
    sf = rng.integers(0, 64, (40, 52)).astype(np.int32)
    wl = rng.integers(0, 16, (40, 52)).astype(np.int32)
    want = jax_coding.quantize_js(coeffs, sf, wl)
    assert np.array_equal(coding.quantize_js(_t(coeffs), _t(sf), _t(wl)).numpy(), want)


def test_grouping_and_scale_factors_equal_gold():
    frames = EXPECT["inputs"]["white_noise"]
    modes = np.random.default_rng(8).choice([0, 2, 3], (frames.shape[0], 3)).astype(np.int32)
    coeffs = (frames * 0.01).astype(np.float32)
    want = jax_encoder._group_bfus(coeffs, modes)
    got = group_bfus(_t(coeffs), _t(modes))
    assert _same(got.numpy(), want)
    slot = np.arange(20)[None, :] < JAX_SPECS[:, None]
    assert np.array_equal(coding.find_scale_factors(got).numpy(), jax_coding.find_scale_factors(want, slot))


# ---------------------------------------------------------------------------
# the encoder, whole
# ---------------------------------------------------------------------------
def test_golden_signal_byte_equal_golden_aea():
    frames = EXPECT["inputs"]["golden"]
    fd, state = port.gold_encode_frames(frames, device="cpu")
    want, want_state = jax_encoder.gold_encode_frames(frames)
    _assert_fd_equal(fd, want)
    assert all(_same(state[k].numpy(), want_state[k]) for k in want_state)
    _, golden = jax_aea.read_aea(os.path.join(FIXTURES, "golden.aea"))
    assert np.array_equal(pack_frames(fd).numpy(), golden)


@pytest.mark.parametrize("cls", CLASSES)
def test_signal_class_byte_equal_gold(cls):
    frames = EXPECT["inputs"][cls]
    fd, _ = encoder.gold_encode_frames(frames, device="cpu")
    want, _ = jax_encoder.gold_encode_frames(frames)
    _assert_fd_equal(fd, want)
    assert np.array_equal(pack_frames(fd).numpy(), EXPECT["units"][(cls, 1.0)])


@pytest.mark.parametrize("cls", testing.EXACT_BIAS_CLASSES)
@pytest.mark.parametrize("bias", testing.EXACT_BIASES)
def test_allocation_bias_byte_equal_gold(cls, bias):
    frames = EXPECT["inputs"][cls]
    fd, _ = encoder.gold_encode_frames(frames, EncoderOptions(allocation_bias=bias), device="cpu")
    want, _ = jax_encoder.gold_encode_frames(frames, JaxOptions(allocation_bias=bias))
    _assert_fd_equal(fd, want)
    assert np.array_equal(pack_frames(fd).numpy(), EXPECT["units"][(cls, bias)])


def test_stereo_pair_is_two_gold_channels():
    pair = np.stack([EXPECT["inputs"]["sine_mix"], EXPECT["inputs"]["pink_ish"]])
    options = EncoderOptions(transient_threshold_low=0.5, per_band_thresholds=True)
    fd, state = encoder.gold_encode_frames(pair, options, device="cpu")
    jopts = JaxOptions(transient_threshold_low=0.5, per_band_thresholds=True)
    for ch in range(2):
        want, want_state = jax_encoder.gold_encode_frames(pair[ch], jopts)
        _assert_fd_equal(fd[ch], want)
        assert all(_same(state[k][ch].numpy(), want_state[k]) for k in want_state)


@pytest.mark.parametrize("chunk", [3, 16, 87])
def test_chunked_encode_pcm_equals_one_chunk(chunk):
    """encode_pcm(engine="exact") in chunks of 3, 16 and 87 frames: the units
    of one chunk (golden.aea; the 3-frame chunks on the transients class)."""
    if chunk == 3:
        frames = EXPECT["inputs"]["transients"]
        want = EXPECT["units"][("transients", 1.0)]
    else:
        frames = EXPECT["inputs"]["golden"]
        want = jax_aea.read_aea(os.path.join(FIXTURES, "golden.aea"))[1]
    got = port.encode_pcm(frames.reshape(1, -1), engine="exact", device="cpu", chunk_frames=chunk)
    assert np.array_equal(got, want)


def test_fixture_holds_its_sources():
    """The stored inputs are the golden signal and the first 32 frames of
    each class made here; gold turns them into the stored units."""
    assert _same(EXPECT["inputs"]["golden"], _golden_signal())
    n = testing.EXACT_CLASS_FRAMES * 512
    for cls, sig in testing.signals(1.0).items():
        assert _same(EXPECT["inputs"][cls], sig[:n].reshape(-1, 512)), cls
    for (name, bias), units in EXPECT["units"].items():
        fd, _ = jax_encoder.gold_encode_frames(EXPECT["inputs"][name], JaxOptions(allocation_bias=bias))
        assert np.array_equal(jax_pack(fd), units), (name, bias)
    assert sorted(EXPECT["units"]) == sorted([("golden", 1.0)] + [(c, 1.0) for c in CLASSES] + [
        (c, b) for c in testing.EXACT_BIAS_CLASSES for b in testing.EXACT_BIASES])


def test_gold_decode_names_the_exact_decoder():
    _, units = jax_aea.read_aea(os.path.join(FIXTURES, "golden.aea"))
    fd = jax_unpack(units[:20])
    want, _ = jax_gold_decode(fd)
    got, _ = port.gold_decode_frames(port.unpack_frames(_t(units[:20])), device="cpu")
    assert _same(got.numpy(), want)
    assert port.gold.decoder_init_state("cpu").keys() == port.decoder_init_state("cpu").keys()


def test_exact_modules_use_no_fused_or_reordered_ops():
    """No fused multiply-add (alpha=, addcmul, lerp, addmm, baddbmm, fma) and no
    reduction of unfixed order (sum, cumsum, mean, matmul) is called on the
    exact encoder's path (read with `ast`): every a*b + c is two ops, every
    sum a left-to-right loop."""
    banned = {"addcmul", "addcdiv", "lerp", "addmm", "baddbmm", "addbmm", "addmv", "fma", "sum", "cumsum", "nansum",
              "mean", "matmul", "mm", "bmm", "einsum", "dot", "tensordot", "conv1d", "linear"}
    paths = [os.path.join(GOLD_DIR, n) for n in sorted(os.listdir(GOLD_DIR)) if n.endswith(".py")]
    paths += [heap_kernels.__file__, qmf_kernels.__file__]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                assert name not in banned, f"{os.path.basename(path)}:{node.lineno} calls {name}"
                assert all(k.arg != "alpha" for k in node.keywords), f"{os.path.basename(path)}:{node.lineno}"


# ---------------------------------------------------------------------------
# the entry points with engine="exact"
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def exact_files(tmp_path_factory):
    """A short stereo int16 WAV (a burst for short blocks, a ragged tail),
    encoded by the JAX package's exact engine and decoded by it."""
    d = tmp_path_factory.mktemp("exact")
    rng = np.random.default_rng(11)
    n = 20 * 512 + 99
    x = rng.standard_normal((2, n)) * 0.15
    x[:, n // 2: n // 2 + 200] += 0.6
    i16 = jax_wav.float_to_int16(x.astype(np.float32))
    paths = {k: str(d / k) for k in ("in.wav", "jax.aea", "jax.wav")}
    wav.write_wav(paths["in.wav"], i16)
    jax_processor.encode_file(paths["in.wav"], paths["jax.aea"], engine="exact", title="t", chunk_frames=CHUNK)
    jax_processor.decode_file(paths["jax.aea"], paths["jax.wav"], engine="exact", chunk_frames=CHUNK)
    return {"i16": i16, **paths}


def test_encode_pcm_byte_equal_jax_exact(exact_files):
    pcm = exact_files["i16"].astype(np.float32) / 32768.0
    want = jax_processor.encode_pcm(pcm, engine="exact", chunk_frames=CHUNK)
    assert np.array_equal(port.encode_pcm(exact_files["i16"], engine="exact", device="cpu", chunk_frames=CHUNK), want)
    assert np.array_equal(port.encode_pcm(pcm, engine="exact", device="cpu", chunk_frames=5), want)


def test_encode_and_decode_file_byte_equal_jax_exact(exact_files, tmp_path):
    aea_out, wav_out = str(tmp_path / "o.aea"), str(tmp_path / "o.wav")
    port.encode_file(exact_files["in.wav"], aea_out, title="t", chunk_frames=CHUNK, device="cpu", engine="exact")
    assert _bytes(aea_out) == _bytes(exact_files["jax.aea"])
    port.decode_file(aea_out, wav_out, chunk_frames=CHUNK, device="cpu", engine="exact")
    assert _bytes(wav_out) == _bytes(exact_files["jax.wav"])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_exact_encode_resumes_across_packages(exact_files, tmp_path, first):
    """Killed after the second chunk by one package, resumed by the other
    (the checkpoint holds gold's per-channel state): the uninterrupted bytes."""
    runs = {"jax": lambda **kw: jax_processor.encode_file(engine="exact", **kw),
            "port": lambda **kw: port.encode_file(device="cpu", engine="exact", **kw)}
    second = "port" if first == "jax" else "jax"
    kw = dict(input_wav=exact_files["in.wav"], output_aea=str(tmp_path / "out.aea"), title="t", chunk_frames=CHUNK,
              checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=1)
    with pytest.raises(KeyboardInterrupt):
        runs[first](on_progress=_KillAt(2), **kw)
    offset, states, _ = streams.StreamCheckpoint(kw["checkpoint"]).load()
    assert offset == 2 * CHUNK and len(states) == 2 and set(states[0]) == set(port.encoder_init_state("cpu"))
    runs[second](**kw)
    assert _bytes(kw["output_aea"]) == _bytes(exact_files["jax.aea"])


def test_exact_encode_killed_and_resumed_in_the_port(exact_files, tmp_path):
    kw = dict(title="t", chunk_frames=CHUNK, device="cpu", engine="exact", checkpoint=str(tmp_path / "ck.npz"),
              checkpoint_every=1)
    out = str(tmp_path / "r.aea")
    with pytest.raises(KeyboardInterrupt):
        port.encode_file(exact_files["in.wav"], out, on_progress=_KillAt(1), **kw)
    port.encode_file(exact_files["in.wav"], out, **kw)
    assert not os.path.exists(kw["checkpoint"]) and _bytes(out) == _bytes(exact_files["jax.aea"])


def test_cli_engine_exact_equals_jax_cli(exact_files, tmp_path):
    for op, src in (("--encode", exact_files["in.wav"]), ("--decode", exact_files["jax.aea"])):
        ext = ".aea" if op == "--encode" else ".wav"
        got, want = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
        common = [op, "--engine", "exact", "--chunk-frames", str(CHUNK), "--quiet"]
        assert cli.main(common + [src, got, "--device", "cpu", "--title", "t"]) == 0
        assert jax_cli.main(common + [src, want, "--title", "t"]) == 0
        assert _bytes(got) == _bytes(want)


def test_corpus_and_launcher_engine_exact(exact_files, tmp_path):
    """transcode_corpus(engine="exact") and the launcher's --engine exact
    (one process) equal encode_file of each file alone."""
    half = exact_files["i16"][:, : 9 * 512 + 5]
    wavs = []
    for i, part in enumerate((exact_files["i16"], half)):
        wavs.append(str(tmp_path / f"part{i}.wav"))
        wav.write_wav(wavs[-1], part)
    jobs = [(w, w[:-4] + ".aea") for w in wavs]
    res = port.transcode_corpus(jobs, device="cpu", engine="exact")
    assert res.completed == wavs and not res.failed
    out_dir = str(tmp_path / "mh")
    assert multihost.main(["--encode", str(tmp_path / "part*.wav"), "--out-dir", out_dir, "--device", "cpu",
                           "--engine", "exact"]) == 0
    for w, o in jobs:
        alone = str(tmp_path / "alone.aea")
        port.encode_file(w, alone, title=os.path.basename(o)[:-4], device="cpu", engine="exact")
        assert _bytes(o) == _bytes(alone) == _bytes(os.path.join(out_dir, os.path.basename(o)))


def test_unknown_engine_raises(exact_files, tmp_path):
    with pytest.raises(ValueError, match="Unknown engine"):
        port.encode_pcm(np.zeros((1, 512), np.float32), engine="fast", device="cpu")
    with pytest.raises(ValueError, match="Unknown engine"):
        port.decode_units(np.zeros((0, 212), np.uint8), 1, engine="fast", device="cpu")
    with pytest.raises(ValueError, match="Unknown engine"):
        port.encode_file(exact_files["in.wav"], str(tmp_path / "x.aea"), engine="fast", device="cpu")
    with pytest.raises(ValueError, match="Unknown engine"):
        port.decode_file(exact_files["jax.aea"], str(tmp_path / "x.wav"), engine="fast", device="cpu")
    assert not os.path.exists(tmp_path / "x.aea") and not os.path.exists(tmp_path / "x.wav")
    with pytest.raises(SystemExit):
        cli.main(["--engine", "fast", "--encode", exact_files["in.wav"], str(tmp_path / "y.aea")])


def test_exact_engine_round_trip_int16_equals_gold():
    """int16 PCM -> exact encode -> units -> exact decode -> int16: the JAX
    package's exact engine, sample for sample."""
    i16 = float_to_int16(_t(EXPECT["inputs"]["chirp"].reshape(1, -1))).numpy()
    units = port.encode_pcm(i16, engine="exact", device="cpu")
    got = port.decode_units(units, 1, engine="exact", device="cpu", to_i16=True).numpy()
    want = jax_processor.decode_units(jax_processor.encode_pcm(i16.astype(np.float32) / 32768.0, engine="exact"),
                                      1, engine="exact")
    assert np.array_equal(got, jax_wav.float_to_int16(want))


# ---------------------------------------------------------------------------
# K5 and K6 as the card runs them: rank keys, masks, the thread-to-data map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bias", [0.5, 0.7, 1.0, 2.0, 3.0])
def test_heap_rank_table_keeps_the_priority_order(bias):
    """Every pair of entries compares the same way by rank as by f64
    priority (equal ranks exactly where the priorities are equal), the
    priorities are finite and every rank fits the kernel's 10 bits."""
    pri = heap_priority_table(bias).reshape(-1)
    rank = heap_rank_table(bias).reshape(-1).astype(np.int64)
    assert np.isfinite(pri).all() and rank.max() < 1024 and heap_rank_table(bias).dtype == np.uint16
    assert np.array_equal(np.sign(rank[:, None] - rank[None, :]), np.sign(pri[:, None] - pri[None, :]))


@pytest.mark.parametrize("name,bias", sorted(EXPECT["units"]))
def test_rank_keyed_heap_equals_gold_units(name, bias):
    """The rank-keyed plain heap on the scale factors of the gold engine's
    units gives their word lengths, frame for frame."""
    fd = jax_unpack(EXPECT["units"][(name, bias)])
    got = heap_kernels.alloc_heap_plain(_t(np.asarray(fd.scale_factors, np.int32)), bias).numpy()
    assert np.array_equal(got, np.asarray(fd.word_lengths))


def _heap_kernel_emulation(sf_idx: np.ndarray, bias: float, budget: int) -> np.ndarray:
    """`csrc/alloc_heap.cu`'s loop for each frame, on its tables: 16-bit keys
    (rank << 6 | BFU), a child winning only with key > (other | 63), key 0
    in the slot past the last entry, the root key held between steps, one
    sift per step, (sf << 4 | wl) per BFU, the [52, 16] cost table, and the
    stop once fewer than the cheapest step's bits remain."""
    rank = np.zeros((64, 16), np.int64)
    rank[:, :15] = heap_rank_table(bias)
    cost = heap_kernels.cost_table().astype(np.int64)
    out = np.zeros(sf_idx.shape, np.int32)
    for f, row in enumerate(sf_idx):
        key = [0] * 53

        def sift(i, n, k):
            start, top = i, k
            while 2 * i + 1 < n:
                left = 2 * i + 1
                kl, kr = key[left], key[left + 1]
                right = kr > (kl | 63)
                kc = kr if right else kl
                if kc <= (k | 63):
                    break
                key[i] = kc
                top = kc if i == start else top
                i = left + right
            key[i] = k
            return top

        sw = [int(min(max(s, 0), 63)) << 4 for s in row]
        n = 0
        for b, s in enumerate(row):
            if s > 0 and cost[b, 0] > 0:
                key[n] = (int(rank[s, 0]) << 6) | b
                n += 1
        key[n] = 0
        for i in range(n // 2 - 1, -1, -1):
            sift(i, n, key[i])
        root, remaining = key[0], budget
        while remaining >= heap_kernels.MIN_STEP_BITS and n > 0:
            b = root & 63
            v = sw[b]
            w = v & 15
            c, c_next = int(cost[b, w]), int(cost[b, w + 1])
            k = (int(rank[v >> 4, w + 1]) << 6) | b
            pop = c > remaining or c <= 0
            if not pop:
                remaining -= c
                sw[b] = v + 1
                pop = c_next <= 0
            if pop:
                n -= 1
                k, key[n] = key[n], 0
            if n > 0:
                root = sift(0, n, k)
        out[f] = [v & 15 for v in sw]
    return out


@pytest.mark.parametrize("bias", [0.7, 2.0])
def test_heap_kernel_emulation_equals_the_plain_heap(bias):
    """The kernel's control flow, emulated, on every K5 edge input and
    budget: the plain version's word lengths (gold's, held above)."""
    for name, sf, budget in testing.heap_edge_cases(heap_kernels.BLOCK_FRAMES):
        want = heap_kernels.alloc_heap_plain(_t(sf), bias, budget).numpy()
        assert np.array_equal(_heap_kernel_emulation(sf, bias, budget), want), (name, budget)


def test_heap_plain_counts_its_chains():
    """`counts` gets each frame's accepted steps (the word lengths' sum),
    pops (every heap entry leaves it) and compared levels."""
    sf = testing.heap_edge_cases(heap_kernels.BLOCK_FRAMES)[0][1]
    counts = {}
    wl = heap_kernels.alloc_heap_plain(_t(sf), 1.0, counts=counts).numpy()
    assert np.array_equal(counts["steps"].numpy(), wl.sum(axis=1))
    entries = (sf > 0).sum(axis=1)
    assert (counts["pops"].numpy() <= entries).all() and (counts["levels"].numpy() >= 0).all()
    assert int(counts["levels"].sum()) > 0


@pytest.mark.parametrize("mask", sorted(testing.ROW_MASKS))
def test_masked_short_mdct_plain_is_mdct_or_zero(mask):
    """`mdct_js_masked`'s plain version: `mdct_js_plain` on active rows, +0
    elsewhere; the wrapper on the CPU is that plain version."""
    x = _rows(37, 64, 64)
    active = testing.ROW_MASKS[mask](x.shape[0])
    got = fftjs_kernels.mdct_js_masked(_t(x), _t(active)).numpy()
    full = transforms.mdct_js_plain(_t(x), 64).numpy()
    assert _same(got[active], full[active])
    assert np.array_equal(got[~active].view(np.int32), np.zeros_like(got[~active]).view(np.int32))
    assert _same(transforms.mdct_masked(_t(x), _t(active), plain=True).numpy(), got)


def test_masked_mdct_wrapper_rejects_bad_masks():
    x = torch.zeros(4, 64)
    for mask in (torch.ones(4, dtype=torch.int32), torch.ones(5, dtype=torch.bool), torch.ones(2, 4, dtype=torch.bool)):
        with pytest.raises(ValueError):
            fftjs_kernels.mdct_js_masked(x, mask)
    with pytest.raises(ValueError):
        fftjs_kernels.mdct_js_masked(torch.zeros(4, 256), torch.ones(4, dtype=torch.bool))


def _bitrev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _position(bits: int, b: int, nb: int, j: int, v: int) -> int:
    """`position<BITS, B, NB>(j, v)` of `csrc/fft_js.cu`."""
    m, g = v & ((1 << nb) - 1), v >> nb
    rest = (g << (bits - 3)) | j
    return ((rest >> b) << (b + nb)) | (m << b) | (rest & ((1 << b) - 1))


def _butterfly(er, ei, orr, oi, wr, wi):
    o_r, o_i, e_r, e_i = (a.astype(np.float64) for a in (orr, oi, er, ei))
    t_r = o_r * wr - o_i * wi
    t_i = o_r * wi + o_i * wr
    return ((e_r + t_r).astype(np.float32), (e_i + t_i).astype(np.float32),
            (e_r - t_r).astype(np.float32), (e_i - t_i).astype(np.float32))


def _k6_map(first, n: int, tw_re: np.ndarray, tw_im: np.ndarray):
    """K6's thread-to-data map for an n-point FFT (n/8 threads of 8 values),
    on a batch of rows.  `first(e)` gives element e's (re, im) [rows] f32.
    Each pass runs stages B .. B+NB-1 (B = 0, 3, 6) on the values a thread
    holds; between passes the values go through the exchange row's slots
    (p + p // 8), each slot written once and read once per pass.  Returns
    {FFT output position: (re, im)} after the last stage."""
    bits, threads = n.bit_length() - 1, n // 8
    passes = [(b, min(3, bits - b)) for b in range(0, bits, 3)]
    re, im = {}, {}
    for j in range(threads):                       # the first pass's positions 8j + v hold element bitrev(8j + v)
        for v in range(8):
            e = (_bitrev(v, 3) << (bits - 3)) | _bitrev(j, bits - 3)
            assert e == _bitrev(8 * j + v, bits) and _position(bits, 0, 3, j, v) == 8 * j + v
            re[j, v], im[j, v] = first(e)
    for pi, (b, nb) in enumerate(passes):
        if pi:                                     # load this pass's positions from the exchange row
            assert sorted(_position(bits, b, nb, j, v) for j in range(threads) for v in range(8)) == list(range(n))
            for j in range(threads):
                for v in range(8):
                    p = _position(bits, b, nb, j, v)
                    re[j, v], im[j, v] = exchange.pop(p + (p >> 3))
        for lb in range(nb):
            q = b + lb
            for j in range(threads):
                for v in range(8):
                    if v & (1 << lb):
                        continue
                    p, p2 = _position(bits, b, nb, j, v), _position(bits, b, nb, j, v | (1 << lb))
                    assert p2 == p + (1 << q)                        # the butterfly's partner
                    k = p & ((1 << q) - 1)
                    if b == 0:
                        assert k == v & ((1 << q) - 1)               # the kernel's compile-time first twiddles
                    w = (1 << q) - 1 + k
                    u = v | (1 << lb)
                    re[j, v], im[j, v], re[j, u], im[j, u] = _butterfly(re[j, v], im[j, v], re[j, u], im[j, u],
                                                                         tw_re[w], tw_im[w])
        if pi < len(passes) - 1:                   # store into the exchange row
            exchange = {}
            for j in range(threads):
                for v in range(8):
                    p = _position(bits, b, nb, j, v)
                    s = p + (p >> 3)
                    assert s not in exchange and s < n + n // 8
                    exchange[s] = (re[j, v], im[j, v])
    b, nb = passes[-1]
    outputs = {_position(bits, b, nb, j, v): (re[j, v], im[j, v]) for j in range(threads) for v in range(8)}
    assert sorted(outputs) == list(range(n))
    return outputs


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_fftjs_thread_map_emulation_equals_gold_fft(n):
    """K6's map of points to threads, passes and exchange slots, emulated
    with the kernel's f64 operations and f32 stores: gold's fft_js bit for
    bit, on edge and random rows."""
    _, tw_re, tw_im = fft_tables(n)
    x_re, x_im = _rows(9, n, n), _rows(9, n, n + 7)
    out = _k6_map(lambda e: (x_re[:, e], x_im[:, e]), n, tw_re, tw_im)
    want = jax_fftjs.fft_js(x_re, x_im)
    assert _same(np.stack([out[i][0] for i in range(n)], -1), want[0])
    assert _same(np.stack([out[i][1] for i in range(n)], -1), want[1])


@pytest.mark.parametrize("kind,size", [("mdct", 256), ("mdct", 512), ("spectrum", 128), ("spectrum", 256)])
def test_fftjs_kernel_emulation_equals_gold(kind, size):
    """The whole kernel's map: the MDCT's pre-twiddle read at each thread's
    elements and its post-twiddle and interleave written from each thread's
    outputs, or the spectrum's real input and its first n/2 magnitudes,
    each output word written once: gold's transform bit for bit."""
    x = _rows(9, size, size)
    if kind == "mdct":
        n = size // 4
        sincos, _, tw_re, tw_im = mdct_tables(size)

        def first(e):
            i = 2 * e
            xv = x.astype(np.float64)
            if i < n:
                a, b = xv[:, 3 * n - 1 - i] + xv[:, 3 * n + i], xv[:, n + i] - xv[:, n - 1 - i]
            else:
                a, b = xv[:, 3 * n - 1 - i] - xv[:, i - n], xv[:, n + i] + xv[:, 5 * n - 1 - i]
            c, s = sincos[2 * e], sincos[2 * e + 1]
            return (a * c + b * s).astype(np.float32), (b * c - a * s).astype(np.float32)
    else:
        n = size
        _, tw_re, tw_im = fft_tables(n)

        def first(e):
            return x[:, e], np.zeros(x.shape[0], np.float32)

    outputs = _k6_map(first, n, tw_re, tw_im)
    got, written = {}, []
    for i, (r, m) in outputs.items():
        rv, iv = r.astype(np.float64), m.astype(np.float64)
        if kind == "mdct":
            c, s = sincos[2 * i], sincos[2 * i + 1]
            got[2 * i] = (-rv * c - iv * s).astype(np.float32)
            got[2 * n - 1 - 2 * i] = (-rv * s + iv * c).astype(np.float32)
            written += [2 * i, 2 * n - 1 - 2 * i]
        elif i < n // 2:
            got[i] = np.sqrt(rv * rv + iv * iv).astype(np.float32)
            written.append(i)
    width = 2 * n if kind == "mdct" else n // 2
    assert sorted(written) == list(range(width))
    got = np.stack([got[k] for k in range(width)], -1)
    want = jax_transforms.mdct(x, size) if kind == "mdct" else jax_fftjs.magnitude_spectrum_js(x, size)
    assert _same(got, want)
