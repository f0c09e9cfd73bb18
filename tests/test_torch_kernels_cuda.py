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

from carta1_tpu_torch import EncoderOptions, decode_units, encode_frames, encode_pcm, kernels, testing
from carta1_tpu_torch.io.aea import read_aea
from carta1_tpu_torch.gold import fftjs, transforms
from carta1_tpu_torch.ops import (bitalloc, bitalloc_kernels, bitpack, bitpack_kernels, fftjs_kernels, heap_kernels,
                                  imdct_kernels, qmf_kernels)

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
        lambda: bitpack_kernels.read_fields(
            torch.zeros(2, 128, dtype=torch.int32), torch.zeros(3, 5, dtype=torch.int32),
            torch.zeros(3, 5, dtype=torch.int32), 13, 107,
        ),
    ],
)
def test_kernel_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()
