"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so on a GPU machine without JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tests marked `cuda` skip where no card is present; the others check the
wrappers' input validation, which needs no card.
"""

import os

import numpy as np
import pytest
import torch

from carta1_tpu_torch import EncoderOptions, FrameData, convert, decode_units, encode_frames, encode_pcm, kernels, testing
from carta1_tpu_torch import constants as C
from carta1_tpu_torch.io.aea import read_aea
from carta1_tpu_torch.gold import fftjs, transforms
from carta1_tpu_torch.ops import (bitalloc, bitalloc_kernels, bitpack, bitpack_kernels, fftjs_kernels, heap_kernels,
                                  imdct_kernels, qmf_kernels)
from carta1_tpu_torch.tables import RDO_BUDGET

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        return bool(((a.view(torch.int32) == b.view(torch.int32)) | ((a == 0) & (b == 0))).all())
    return torch.equal(a, b)


def _same_words_as_plain_on_the_cpu(signal: torch.Tensor, delay: torch.Tensor, low: torch.Tensor,
                                     high: torch.Tensor) -> bool:
    """K8's bands against its plain version on the CPU, word for word.  The
    CPU's words are the reference's, NaNs included; on the card ATen's add
    is an FMA of a + 1 * b, which keeps the other NaN where two meet."""
    want = qmf_kernels.qmf_analysis_taps_plain(signal.cpu(), delay.cpu())
    return all(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)) for g, w in zip((low, high), want))


def _spectra(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)) * np.exp2(rng.integers(-10, 4, (rows, cols)))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("size", imdct_kernels.SIZES)
def test_imdct_kernel_matches_plain(card, size):
    x = _spectra(1000, size // 2, size).to(card)
    before = kernels.LAUNCHES[f"imdct_exact_{size}"]
    got = imdct_kernels.imdct_mid(x, size)
    assert kernels.LAUNCHES[f"imdct_exact_{size}"] == before + 1
    assert _same_bits(got, imdct_kernels.imdct_mid_plain(x, size))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 256])
def test_qmf_kernel_matches_plain(card, s):
    work = torch.from_numpy(np.random.default_rng(s).standard_normal((300, 46 + 2 * s)).astype(np.float32)).to(card)
    assert _same_bits(qmf_kernels.qmf_taps(work), qmf_kernels.qmf_taps_plain(work))


@pytest.mark.cuda
@pytest.mark.parametrize("size", imdct_kernels.SIZES)
def test_imdct_kernel_edge_inputs_match_plain(card, size):
    """Batches around a block's tile; +0, -0, denormals, overflow at the
    last rounding, lone coefficients at a row's ends."""
    for batch, seed in testing.edge_cases(imdct_kernels.TILE[size]):
        x = torch.from_numpy(testing.imdct_edge_spectra(size, batch, seed)).to(card)
        assert _same_bits(imdct_kernels.imdct_mid(x, size), imdct_kernels.imdct_mid_plain(x, size)), (batch, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 7, 128, 256])
def test_qmf_kernel_edge_inputs_match_plain(card, s):
    for batch, seed in testing.edge_cases(qmf_kernels.tile_rows(s)):
        work = torch.from_numpy(testing.qmf_edge_work(batch, s, seed)).to(card)
        assert _same_bits(qmf_kernels.qmf_taps(work), qmf_kernels.qmf_taps_plain(work)), (batch, seed)


@pytest.mark.cuda
def test_qmf_kernel_wide_rows_match_plain(card):
    """A width that is no multiple of a thread's run of pairs and spans
    more than one column tile."""
    work = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 46 + 2 * 611)).astype(np.float32)).to(card)
    assert _same_bits(qmf_kernels.qmf_taps(work), qmf_kernels.qmf_taps_plain(work))


@pytest.mark.cuda
def test_read_fields_kernel_matches_plain(card):
    _, units = read_aea(os.path.join(FIXTURES, "golden.aea"))
    rand = np.random.default_rng(5).integers(0, 256, (64, 212)).astype(np.uint8)
    u = torch.from_numpy(np.concatenate([units, rand])).to(card)
    for win32, off, w, lo, hi in bitpack.field_reads(u):
        got = bitpack_kernels.read_fields(win32, off, w, lo, hi)
        assert _same_bits(got, bitpack_kernels.read_fields_plain(win32, off, w, lo, hi))


@pytest.mark.cuda
def test_decode_units_kernels_match_plain_and_golden(card):
    _, units = read_aea(os.path.join(FIXTURES, "golden.aea"))
    golden = np.load(os.path.join(FIXTURES, "golden_decode.npz"))["int16"]
    got = decode_units(units, 1, device=card, to_i16=True)
    assert np.array_equal(got.cpu().numpy().reshape(-1), golden)
    stereo = np.concatenate([units, units[::-1]])
    assert _same_bits(
        decode_units(stereo, 2, device=card, chunk_frames=50),
        decode_units(stereo, 2, device=card, plain=True),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_alloc_kernels_edge_inputs_match_plain(card, bias):
    """Batches around a block's frames; NaN and inf coefficients, silent
    and all-63 frames, exact ties across BFUs, plateaus of the hull,
    denormals.  One launch per call, counted."""
    for name, bfu, sf in testing.alloc_edge_cases(bitalloc_kernels.BLOCK_FRAMES):
        b, s = torch.from_numpy(bfu).to(card), torch.from_numpy(sf).to(card)
        before = dict(kernels.LAUNCHES)
        got, got_ref = bitalloc_kernels.alloc_rdo(b, s, bias), bitalloc_kernels.alloc_reference(s, bias)
        assert kernels.LAUNCHES["alloc_rdo"] == before["alloc_rdo"] + 1, name
        assert kernels.LAUNCHES["alloc_reference"] == before["alloc_reference"] + 1, name
        assert torch.equal(got, bitalloc_kernels.alloc_rdo_plain(b, s, bias)), name
        assert torch.equal(got_ref, bitalloc_kernels.alloc_reference_plain(s, bias)), name


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_allocators_on_the_card_equal_the_plain_path(card, bias):
    bfu, sf = (torch.from_numpy(a).to(card) for a in testing.alloc_inputs("random", 300, 6))
    assert torch.equal(bitalloc.allocate_bits_rdo(bfu, sf, bias), bitalloc.allocate_bits_rdo(bfu, sf, bias, plain=True))
    assert torch.equal(bitalloc.allocate_bits(sf, bias), bitalloc.allocate_bits(sf, bias, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_alloc_reference_kernel_at_the_full_chunk_shape(card, bias):
    """alloc_reference at a stereo 8192-frame chunk's [16384, 52]: rows of
    every chain length between random rows."""
    rng = np.random.default_rng(14)
    sf = testing.reference_mixed_rows(16384, 15)
    sf[1::2] = np.where(rng.random((8192, 52)) < 0.1, 0, rng.integers(20, 64, (8192, 52)))
    s = torch.from_numpy(sf).to(card)
    before = kernels.LAUNCHES["alloc_reference"]
    assert torch.equal(bitalloc_kernels.alloc_reference(s, bias), bitalloc_kernels.alloc_reference_plain(s, bias))
    assert kernels.LAUNCHES["alloc_reference"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_alloc_reference_kernel_blocks_mixing_long_and_short_chains(card, bias):
    """Neighbouring frames (one warp each) whose chains differ in length:
    silent frames beside all-63 frames, exact ties across BFUs, one BFU
    alone, quiet frames; at the codec's budget and at budgets where nothing,
    one step or every step fits."""
    for frames in (1, bitalloc_kernels.BLOCK_FRAMES + 1, 6 * bitalloc_kernels.BLOCK_FRAMES + 5):
        s = torch.from_numpy(testing.reference_mixed_rows(frames, frames)).to(card)
        for budget in (RDO_BUDGET, -3, 0, 37, 5000):
            got = bitalloc_kernels.alloc_reference(s, bias, budget)
            assert torch.equal(got, bitalloc_kernels.alloc_reference_plain(s, bias, budget)), (frames, budget)


@pytest.mark.cuda
def test_encode_on_the_card_matches_plain_and_decodes(card):
    """Units through the kernels equal units through the plain versions,
    twice; the round trip through the card's exact decoder is sane."""
    pcm = testing.synth_audio(600, 2)
    units = encode_pcm(pcm, device=card, chunk_frames=256)
    assert units.shape == (1200, 212)
    assert np.array_equal(units, encode_pcm(pcm, device=card, chunk_frames=256))
    assert np.array_equal(units, encode_pcm(pcm, device=card, chunk_frames=256, plain=True))
    out = decode_units(units, 2, device=card).cpu().numpy()
    assert testing.psnr(pcm[0], out[0]) > 20 and testing.psnr(pcm[1], out[1]) > 20
    fd, _ = encode_frames(pcm[0].reshape(-1, 512)[:64], EncoderOptions(allocator="reference"), device=card)
    fd_cpu, _ = encode_frames(pcm[0].reshape(-1, 512)[:64], EncoderOptions(allocator="reference"), device="cpu")
    assert torch.equal(fd.block_modes.cpu(), fd_cpu.block_modes)


@pytest.mark.cuda
def test_file_transcodes_on_the_card_match_the_cpu_path(card, tmp_path):
    """encode_file on the card gives encode_pcm's units on the card, within
    1% of the bytes of the CPU run; decode_file on the card gives the CPU
    run's WAV byte for byte (decode is bit-exact); every kernel launched;
    a killed and resumed decode gives the same file."""
    from carta1_tpu_torch import decode_file, encode_file
    from carta1_tpu_torch.io.wav import float_to_int16, write_wav

    i16 = float_to_int16(testing.synth_audio(700, 2)[:, : 700 * 512 - 99])
    src, aea_card, aea_cpu = (str(tmp_path / n) for n in ("in.wav", "card.aea", "cpu.aea"))
    write_wav(src, i16)
    kernels.reset_launches()
    encode_file(src, aea_card, chunk_frames=256, device=card)
    decode_file(aea_card, str(tmp_path / "card.wav"), chunk_frames=256, device=card)
    assert all(kernels.LAUNCHES[k] > 0 for k in ("alloc_rdo", "read_fields", "qmf_taps", "imdct_exact_256")), \
        kernels.LAUNCHES
    encode_file(src, aea_cpu, chunk_frames=256, device="cpu")
    _, units = read_aea(aea_card)
    assert np.array_equal(units, encode_pcm(i16, device=card, chunk_frames=256))
    assert (units != read_aea(aea_cpu)[1]).mean() < 0.01
    decode_file(aea_card, str(tmp_path / "cpu.wav"), chunk_frames=256, device="cpu")
    card_wav = open(tmp_path / "card.wav", "rb").read()
    assert card_wav == open(tmp_path / "cpu.wav", "rb").read()

    def kill(done, total):
        if done >= 512:
            raise KeyboardInterrupt("simulated kill")

    resumed, ck = str(tmp_path / "resumed.wav"), str(tmp_path / "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        decode_file(aea_card, resumed, chunk_frames=256, device=card, checkpoint=ck, checkpoint_every=1, on_progress=kill)
    decode_file(aea_card, resumed, chunk_frames=256, device=card, checkpoint=ck, checkpoint_every=1)
    assert open(resumed, "rb").read() == card_wav


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cpu", "cuda:0")], ids=["one_card", "two_groups"])
def test_sharded_decode_on_the_card_equals_unsharded(card, devices):
    """Frames split over the mesh: bitwise the unsharded decode on the card,
    with the state carried across two ragged chunks; the sharded encode
    inside the JAX envelope of the unsharded one, and the kernels launched.
    ("cuda:0", "cpu", "cuda:0") is a mesh of two devices, shards 0 and 2 on
    the card and shard 1 on the CPU: the path of a mesh over several cards
    (cross-device halos and gather).  Its CPU shard encodes with the plain
    versions, so its encode is held to the backends' agreement instead."""
    from carta1_tpu_torch import decode_frames, decode_frames_sharded, encode_frames_sharded, make_mesh
    from carta1_tpu_torch import constants as C
    from carta1_tpu_torch import encoder_init_state
    from carta1_tpu_torch.pipeline.encoder import analysis_step

    mesh = make_mesh(devices)
    _, units = read_aea(os.path.join(FIXTURES, "golden.aea"))
    fd = bitpack.unpack_frames(torch.from_numpy(np.stack([units, units[::-1]])).to(card))    # [2, 87]
    want, want_st = decode_frames(fd, device=card)
    kernels.reset_launches()
    a, st = decode_frames_sharded(fd[:, :50], mesh)
    b, st = decode_frames_sharded(fd[:, 50:], mesh, st)
    assert all(kernels.LAUNCHES[k] > 0 for k in ("qmf_taps", "imdct_exact_256", "imdct_exact_512")), kernels.LAUNCHES
    assert a.device == mesh[0] and _same_bits(torch.cat([a, b], dim=1), want)
    assert all(st[k].device == mesh[0] and _same_bits(st[k], want_st[k]) for k in want_st)

    pcm = torch.from_numpy(testing.synth_audio(300, 2).reshape(2, 300, 512)).to(card)
    kernels.reset_launches()
    got, _ = encode_frames_sharded(pcm, mesh=mesh)
    assert kernels.LAUNCHES["alloc_rdo"] > 0, kernels.LAUNCHES
    ref, _ = encode_frames(pcm, device=card)
    if "cpu" not in devices:
        assert torch.equal(got.block_modes, ref.block_modes) and torch.equal(got.scale_factors, ref.scale_factors)
        qdiff = (got.quantized - ref.quantized).abs()
        assert int(qdiff.max()) <= 1 and float((qdiff != 0).float().mean()) < 1e-3
    else:
        bfu, _, _, _ = analysis_step(pcm, encoder_init_state(card, 2), (1.0,) * 3)
        peaks = torch.where(torch.from_numpy(C.BFU_SLOT_MASK).to(card), bfu.abs(), 0.0).amax(dim=-1)
        testing.backend_agreement({k: getattr(got, k).cpu().numpy() for k in got.fields()},
                                  {k: getattr(ref, k).cpu().numpy() for k in ref.fields()}, peaks.cpu().numpy())


@pytest.mark.cuda
def test_fast_decode_on_the_card_within_the_golden_envelope(card):
    """f32 matmul and conv1d on the card (TF32 off): within one int16 step of
    the reference decoder, in fewer than 1% of the samples."""
    from carta1_tpu_torch import decode_frames
    from carta1_tpu_torch.ops.pcm import float_to_int16

    _, units = read_aea(os.path.join(FIXTURES, "golden.aea"))
    golden = np.load(os.path.join(FIXTURES, "golden_decode.npz"))["int16"]
    pcm, _ = decode_frames(bitpack.unpack_frames(torch.from_numpy(units).to(card)), device=card, fast=True)
    diff = np.abs(float_to_int16(pcm).cpu().numpy().reshape(-1).astype(np.int64) - golden)
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_heap_kernel_edge_inputs_match_plain(card, bias):
    """K5 on its edge inputs: exact ties, silent and all-63 frames, heaps of
    0, 1, 2 and 52 entries, budgets that run out at, before and after the
    last step.  One launch per call, counted."""
    for name, sf, budget in testing.heap_edge_cases(heap_kernels.BLOCK_FRAMES):
        s = torch.from_numpy(sf).to(card)
        before = kernels.LAUNCHES["alloc_heap"]
        got = heap_kernels.alloc_heap(s, bias, budget)
        assert kernels.LAUNCHES["alloc_heap"] == before + 1, name
        assert torch.equal(got, heap_kernels.alloc_heap_plain(s, bias, budget)), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size", [("mdct", s) for s in fftjs_kernels.MDCT_SIZES]
                         + [("spectrum", s) for s in fftjs_kernels.SPECTRUM_SIZES])
def test_fftjs_kernel_edge_inputs_match_plain(card, kind, size):
    """K6 on batches around a block's rows: +0, -0, denormals, huge and lone samples."""
    for batch, seed in testing.edge_cases(fftjs_kernels.ROWS[(kind, size)]):
        x = torch.from_numpy(testing.edge_rows(batch, size, seed, 1e30)).to(card)
        if kind == "mdct":
            got, want = fftjs_kernels.mdct_js(x, size), transforms.mdct_js_plain(x, size)
        else:
            got, want = fftjs_kernels.magnitude_spectrum_js(x, size), fftjs.magnitude_spectrum_js_plain(x, size)
        assert _same_bits(got, want), (batch, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", sorted(testing.ROW_MASKS))
def test_masked_short_mdct_kernel_edge_inputs_match_plain(card, mask):
    """K6's masked MDCT of size 64 on its edge rows under each mask: the
    active rows as the plain MDCT, the others +0; one counted launch."""
    for batch, seed in testing.edge_cases(fftjs_kernels.ROWS[("mdct", 64)]):
        x = torch.from_numpy(testing.edge_rows(batch, 64, seed, 1e30)).to(card)
        active = torch.from_numpy(testing.ROW_MASKS[mask](batch)).to(card)
        before = kernels.LAUNCHES["fft_js_mdct_64"]
        got = fftjs_kernels.mdct_js_masked(x, active)
        assert kernels.LAUNCHES["fft_js_mdct_64"] == before + 1
        assert _same_bits(got, transforms.mdct_js_masked_plain(x, active)), (batch, seed)
        assert not bool(got[~active].view(torch.int32).any()), (batch, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [0.7, 1.0, 2.0])
def test_heap_kernel_warps_mixing_tied_heaps(card, bias):
    """K5 on warps whose frames hold heaps of 0, 1, 2 and 52 entries, every
    entry of a frame at one scale factor: all its priorities tie at every
    step, so heap-array order alone decides."""
    rng = np.random.default_rng(11)
    frames = 4 * heap_kernels.BLOCK_FRAMES + 5
    sf = np.zeros((frames, 52), np.int32)
    for f in range(frames):
        size = (0, 1, 2, 52)[(f * 7 + f // 3) % 4]
        sf[f, rng.choice(52, size, replace=False)] = rng.integers(1, 64)
    s = torch.from_numpy(sf).to(card)
    assert torch.equal(heap_kernels.alloc_heap(s, bias), heap_kernels.alloc_heap_plain(s, bias))


@pytest.mark.cuda
def test_heap_and_fftjs_kernels_at_full_chunk_shapes(card):
    """K5 and every K6 entry at a stereo 8192-frame chunk's shapes of the
    exact engine, the short MDCT masked with about 1% of its rows active."""
    rng = np.random.default_rng(12)
    sf = torch.from_numpy(rng.integers(0, 64, (16384, 52)).astype(np.int32)).to(card)
    assert torch.equal(heap_kernels.alloc_heap(sf, 1.0), heap_kernels.alloc_heap_plain(sf, 1.0))
    x64 = _spectra(262144, 64, 13).to(card)
    active = torch.from_numpy(rng.random(262144) < 0.01).to(card)
    assert _same_bits(fftjs_kernels.mdct_js_masked(x64, active), transforms.mdct_js_masked_plain(x64, active))
    for size, rows in ((256, 32768), (512, 16384)):
        x = _spectra(rows, size, size).to(card)
        assert _same_bits(fftjs_kernels.mdct_js(x, size), transforms.mdct_js_plain(x, size)), size
    for size, rows in ((128, 32768), (256, 16384)):
        x = _spectra(rows, size, size + 1).to(card)
        got = fftjs_kernels.magnitude_spectrum_js(x, size)
        assert _same_bits(got, fftjs.magnitude_spectrum_js_plain(x, size)), size


@pytest.mark.cuda
def test_exact_engine_on_the_card_equals_gold_units(card):
    """encode_pcm(engine="exact") on the card: golden.aea, the fixture's
    classes and biases, byte for byte; 3-frame chunks equal one chunk; K5
    and K6 launched; the plain versions give the same units."""
    expect = testing.exact_expect(os.path.join(FIXTURES, "torch_exact_expect.npz"))
    _, golden = read_aea(os.path.join(FIXTURES, "golden.aea"))
    kernels.reset_launches()
    for (name, bias), want in expect["units"].items():
        pcm = expect["inputs"][name].reshape(1, -1)
        got = encode_pcm(pcm, EncoderOptions(allocation_bias=bias), device=card, engine="exact")
        assert np.array_equal(got, want), (name, bias)
    assert np.array_equal(expect["units"][("golden", 1.0)], golden)
    assert kernels.LAUNCHES["alloc_heap"] and kernels.LAUNCHES["fft_js_mdct_64"] and kernels.LAUNCHES["fft_js_spectrum_256"]
    pcm = expect["inputs"]["transients"].reshape(1, -1)
    want = expect["units"][("transients", 1.0)]
    assert np.array_equal(encode_pcm(pcm, device=card, engine="exact", chunk_frames=3), want)
    assert np.array_equal(encode_pcm(pcm, device=card, engine="exact", plain=True), want)


@pytest.mark.cuda
@pytest.mark.parametrize("size", imdct_kernels.SIZES)
def test_imdct_and_mdct_kernels_at_other_scales_match_plain(card, size):
    """K1 and K6 at scales other than the reference's instances (a scale is
    a sincos table): gold's default scale = size and two more, on the edge
    inputs and a main-path-sized batch, each launch counted."""
    for scale in (float(size), 3.0, 1e-3):
        for batch, seed in testing.edge_cases(imdct_kernels.TILE[size]):
            x = torch.from_numpy(testing.imdct_edge_spectra(size, batch, seed)).to(card)
            got = imdct_kernels.imdct_mid(x, size, scale)
            assert _same_bits(got, imdct_kernels.imdct_mid_plain(x, size, scale)), (scale, batch, seed)
        for batch, seed in testing.edge_cases(fftjs_kernels.ROWS[("mdct", size)]):
            x = torch.from_numpy(testing.edge_rows(batch, size, seed, 1e30)).to(card)
            got = fftjs_kernels.mdct_js(x, size, scale)
            assert _same_bits(got, transforms.mdct_js_plain(x, size, scale)), (scale, batch, seed)
        x = _spectra(4096, size // 2, size).to(card)
        before = kernels.LAUNCHES[f"imdct_exact_{size}"]
        got = imdct_kernels.imdct_mid(x, size, scale)
        assert kernels.LAUNCHES[f"imdct_exact_{size}"] == before + 1
        assert _same_bits(got, imdct_kernels.imdct_mid_plain(x, size, scale))
        x = _spectra(4096, size, size + 1).to(card)
        assert _same_bits(fftjs_kernels.mdct_js(x, size, scale), transforms.mdct_js_plain(x, size, scale))


@pytest.mark.cuda
def test_gold_imdct_js_and_qmf_synthesis_stream_on_the_card(card):
    """One round of the gold surface on the card: imdct_js at gold's default
    scale and qmf_synthesis_stream over a ragged stream (and in three calls
    with the delay carried), each equal to the plain route, K1 and K2
    launched."""
    kernels.reset_launches()
    x = _spectra(2048, 256, 3).to(card)
    got = transforms.imdct_js(x, 512)
    assert _same_bits(got, transforms.imdct_js(x, 512, plain=True))
    s = 3 * 256 + 77
    low, high = _spectra(2, s, 4).to(card) * 1e-3, _spectra(2, s, 5).to(card) * 1e-3
    delay = torch.zeros(2, 46, device=card)
    out, new_delay = transforms.qmf_synthesis_stream(low, high, delay)
    want, want_delay = transforms.qmf_synthesis_stream(low, high, delay, plain=True)
    assert _same_bits(out, want) and _same_bits(new_delay, want_delay)
    parts, d = [], delay
    for a, b in ((0, 100), (100, 600), (600, s)):
        o, d = transforms.qmf_synthesis_stream(low[:, a:b], high[:, a:b], d)
        parts.append(o)
    assert _same_bits(torch.cat(parts, dim=-1), out) and _same_bits(d, new_delay)
    assert kernels.LAUNCHES["imdct_exact_512"] and kernels.LAUNCHES["qmf_taps"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 7, 45, 46, 47, 300, 2 * 1025 + 1, 2 * 4096 + 77])
def test_qmf_analysis_kernel_edge_inputs_match_plain(card, n):
    """K8 against its plain version: batches around a block's rows and zero
    rows; odd N, N shorter than the delay, N < 2 (nothing launched), a
    ragged last column tile; +-0, denormals, +-inf, NaN, +-F32_MAX rows whose
    sums overflow, each behind a nonzero delay of its own.  0 differing
    words from the plain version on the CPU; one launch a call that has
    outputs."""
    tile_rows, _ = qmf_kernels.analysis_tile(n)
    for batch, seed in testing.edge_cases(tile_rows) + [(0, 0)]:
        signal, delay = (torch.from_numpy(a).to(card) for a in testing.qmf_analysis_edge_inputs(batch, n, seed))
        before = kernels.LAUNCHES["qmf_analysis"]
        low, high = qmf_kernels.qmf_analysis_taps(signal, delay)
        assert kernels.LAUNCHES["qmf_analysis"] == before + (batch > 0 and n >= 2), (batch, seed)
        assert _same_words_as_plain_on_the_cpu(signal, delay, low, high), (batch, seed)


@pytest.mark.cuda
def test_qmf_analysis_kernel_at_the_exact_cell_shape(card):
    """Both tree levels of one exact-encode call of 16 rows x 8,192 frames,
    on random and edge rows: 0 differing words from the plain version on
    the CPU."""
    rng = np.random.default_rng(25)
    signal = torch.from_numpy((rng.standard_normal((16, 8192 * 512)) * 0.3).astype(np.float32)).to(card)
    edge, edge_delay = testing.qmf_analysis_edge_inputs(16, 2048, 3)
    signal[:, :2048] = torch.from_numpy(edge).to(card)
    delay = torch.from_numpy(edge_delay).to(card)
    for _ in range(2):
        low, high = qmf_kernels.qmf_analysis_taps(signal, delay)
        assert _same_words_as_plain_on_the_cpu(signal, delay, low, high), signal.shape
        signal, delay = low, signal[:, -46:].contiguous()


@pytest.mark.cuda
def test_qmf_analysis_stream_on_the_card_chunked_equals_whole(card):
    """gold/transforms.qmf_analysis_stream on K8: the plain route's bands and
    new delay; a stream cut into chunks of even lengths (one shorter than
    the delay) and an odd tail equals the whole stream, new delay included."""
    rng = np.random.default_rng(9)
    signal = torch.from_numpy((rng.standard_normal((3, 5 * 512 + 41)) * 0.3).astype(np.float32)).to(card)
    delay = torch.from_numpy((rng.standard_normal((3, 46)) * 0.1).astype(np.float32)).to(card)
    low, high, last = transforms.qmf_analysis_stream(signal, delay)
    want = transforms.qmf_analysis_stream(signal, delay, plain=True)
    assert all(_same_bits(g, w) for g, w in zip((low, high, last), want))
    parts, d = [], delay
    for a, b in ((0, 30), (30, 1030), (1030, signal.shape[1])):
        lo, hi, d = transforms.qmf_analysis_stream(signal[:, a:b].contiguous(), d)
        parts.append((lo, hi))
    assert _same_bits(torch.cat([p[0] for p in parts], dim=-1), low)
    assert _same_bits(torch.cat([p[1] for p in parts], dim=-1), high)
    assert _same_bits(d, last)


@pytest.mark.cuda
def test_exact_encode_launches_k8_twice_a_step_and_equals_the_cpu(card):
    """Each exact encode step launches K8 once per tree level; the card's
    units equal the CPU's (the plain versions) on a short stereo clip."""
    pcm = testing.synth_audio(300, 2)
    kernels.reset_launches()
    got = encode_pcm(pcm, engine="exact", chunk_frames=128, device=card)
    assert kernels.LAUNCHES["qmf_analysis"] == 2 * 3
    assert np.array_equal(got, encode_pcm(pcm, engine="exact", chunk_frames=128, device="cpu"))


def _pack_call(frames: int = 4, dtype=torch.int32, **change):
    """pack_units on CPU fields of `frames` frames, `change` replacing some."""
    fields = {name: torch.zeros((frames, *tail), dtype=dtype) for name, tail in bitpack_kernels.PACK_FIELDS}
    fields.update(change)
    return lambda: bitpack_kernels.pack_units(*fields.values())


def _pack_checked(fd: FrameData) -> torch.Tensor:
    """K7's units of `fd` (on the card), held to the plain version's bytes,
    with one launch counted."""
    before = kernels.LAUNCHES["pack_units"]
    got = bitpack.pack_frames(fd)
    assert kernels.LAUNCHES["pack_units"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == (*fd.n_bfu.shape, C.SOUND_UNIT_SIZE)
    assert torch.equal(got, bitpack.pack_frames(fd, plain=True))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_bfu", [0, *C.BFU_AMOUNTS.tolist(), "per frame"])
def test_pack_kernel_every_bfu_amount_matches_plain(card, n_bfu):
    """Each frame laid out for its own n_bfu: every amount, and amounts
    drawn per frame from all of [0, 52] (most of them no BFU amount)."""
    n = 2048
    nb = np.random.default_rng(21).integers(0, 53, n) if n_bfu == "per frame" else n_bfu
    _pack_checked(convert.framedata_from_numpy(testing.random_framedata(n, 21, nb), card))


@pytest.mark.cuda
@pytest.mark.parametrize("max_wl", [0, 6, 15])
@pytest.mark.parametrize("n_bfu", [52, "per frame"])
def test_pack_kernel_random_fields_match_plain(card, max_wl, n_bfu):
    """Word lengths up to 15 run far past bit 1695 (dropped); 0 everywhere
    leaves the header and the side information alone."""
    n = 4099
    nb = np.random.default_rng(max_wl).integers(0, 53, n) if n_bfu == "per frame" else n_bfu
    _pack_checked(convert.framedata_from_numpy(testing.random_fields(n, 30 + max_wl, nb, max_wl), card))


@pytest.mark.cuda
def test_pack_kernel_edge_inputs_match_plain(card):
    """Batches around a block's frames; every BFU amount, n_bfu per frame,
    below 0 and past 52, word lengths 0 and up to 15, every field outside
    its range."""
    for name, fd in testing.pack_edge_cases(bitpack_kernels.BLOCK_FRAMES):
        before = kernels.LAUNCHES["pack_units"]
        got = bitpack.pack_frames(convert.framedata_from_numpy(fd, card))
        assert kernels.LAUNCHES["pack_units"] == before + 1, name
        want = bitpack.pack_frames_plain(convert.framedata_from_numpy(fd, "cpu"))
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
def test_pack_kernel_keeps_channel_axis(card):
    """[2, F] fields as one launch, equal to each channel alone; a strided
    view of them (copied where not contiguous) equal to its copy's units."""
    nb = np.random.default_rng(8).integers(0, 53, (2, 777))
    rows = [testing.random_fields(777, 40 + ch, nb[ch], 15) for ch in range(2)]
    fd = convert.framedata_from_numpy(FrameData(*(np.stack([getattr(r, k) for r in rows]) for k in FrameData.fields())), card)
    got = _pack_checked(fd)
    for ch in range(2):
        assert torch.equal(got[ch], _pack_checked(fd[ch]))
    strided = fd[:, ::3]
    assert not strided.quantized.is_contiguous()
    assert torch.equal(_pack_checked(strided), got[:, ::3])


@pytest.mark.cuda
def test_pack_kernel_at_the_batched_cell_chunk(card):
    """One call's encoder output in the batched encode cell: 32 rows of
    8,192 frames (262,144 frames) in one launch, equal to the plain pack."""
    g = torch.Generator(device=card).manual_seed(32)
    t = torch.arange(8192 * 512, device=card, dtype=torch.float32) / 44100.0
    tones = torch.sin(2 * np.pi * (110.0 + 55.0 * torch.arange(32, device=card, dtype=torch.float32))[:, None] * t)
    pcm = 0.3 * tones + 0.05 * torch.randn((32, 8192 * 512), generator=g, device=card)
    fd, _ = encode_frames(pcm.reshape(32, 8192, 512), device=card)
    del pcm, tones, t
    assert fd.quantized.is_contiguous() and fd.word_lengths.is_contiguous()
    _pack_checked(fd)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["tpu", "exact"])
def test_encode_pcm_units_equal_with_and_without_the_pack_kernel(card, engine):
    """`plain=True` packs with the plain version, the default with K7, once
    per chunk: the same units."""
    pcm = testing.synth_audio(300, 2)
    kernels.reset_launches()
    got = encode_pcm(pcm, engine=engine, chunk_frames=128, device=card)
    assert kernels.LAUNCHES["pack_units"] == 3
    kernels.reset_launches()
    want = encode_pcm(pcm, engine=engine, chunk_frames=128, device=card, plain=True)
    assert kernels.LAUNCHES["pack_units"] == 0
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "call",
    [
        lambda: bitalloc_kernels.alloc_rdo(torch.zeros(4, 52, 20), torch.zeros(4, 52, dtype=torch.int64), 1.0),
        lambda: bitalloc_kernels.alloc_reference(torch.zeros(52, dtype=torch.int32), 1.0),
        lambda: bitalloc_kernels.alloc_reference(torch.zeros(52, 4, dtype=torch.int32).T, 1.0),
        lambda: imdct_kernels.imdct_mid(torch.zeros(4, 32, dtype=torch.float64), 64),
        lambda: imdct_kernels.imdct_mid(torch.zeros(4, 33), 64),
        lambda: imdct_kernels.imdct_mid(torch.zeros(4, 64), 128),
        lambda: imdct_kernels.imdct_mid(torch.zeros(64, 4).T, 64),
        lambda: qmf_kernels.qmf_taps(torch.zeros(4, 45)),
        lambda: heap_kernels.alloc_heap(torch.zeros(4, 52, dtype=torch.int64), 1.0),
        lambda: heap_kernels.alloc_heap(torch.zeros(4, 51, dtype=torch.int32), 1.0),
        lambda: fftjs_kernels.mdct_js(torch.zeros(4, 256), 128),
        lambda: fftjs_kernels.mdct_js(torch.zeros(4, 255), 256),
        lambda: fftjs_kernels.mdct_js(torch.zeros(4, 64, dtype=torch.float64), 64),
        lambda: fftjs_kernels.magnitude_spectrum_js(torch.zeros(4, 64), 64),
        lambda: fftjs_kernels.magnitude_spectrum_js(torch.zeros(128, 4).T, 128),
        lambda: fftjs_kernels.mdct_js_masked(torch.zeros(4, 64), torch.ones(4, dtype=torch.int32)),
        lambda: fftjs_kernels.mdct_js_masked(torch.zeros(4, 64), torch.ones(3, dtype=torch.bool)),
        lambda: bitpack_kernels.read_fields(
            torch.zeros(2, 128, dtype=torch.int32), torch.zeros(3, 5, dtype=torch.int32),
            torch.zeros(3, 5, dtype=torch.int32), 13, 107,
        ),
        _pack_call(dtype=torch.int64),
        _pack_call(quantized=torch.zeros(4, 52, 19, dtype=torch.int32)),
        _pack_call(n_bfu=torch.zeros(5, dtype=torch.int32)),
        _pack_call(word_lengths=torch.zeros(52, 4, dtype=torch.int32).T),
        _pack_call(),                                                   # CPU tensors: the plain version's
    ],
)
def test_kernel_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()
