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
from carta1_tpu_torch.ops import heap_kernels
from carta1_tpu_torch.ops.bitpack import pack_frames
from carta1_tpu_torch.ops.coding import group_bfus
from carta1_tpu_torch.ops.pcm import float_to_int16
from carta1_tpu_torch.parallel import multihost
from carta1_tpu_torch.tables import RDO_BUDGET, heap_priority_table

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
        got = coding.allocate_bits(_t(sf), bias).numpy()
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
    paths.append(heap_kernels.__file__)
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
