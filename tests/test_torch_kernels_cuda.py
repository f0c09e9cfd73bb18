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
from carta1_tpu_torch.ops import bitalloc, bitalloc_kernels, bitpack, bitpack_kernels, imdct_kernels, qmf_kernels

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
def test_alloc_sweep_kernel_edge_inputs_match_plain(card):
    """Batches around a block's frames, invalid candidates, every BFU
    abandoned, a budget met exactly, zero costs, widths off the tile."""
    for name, cands in testing.sweep_edge_cases(bitalloc_kernels.BLOCK_FRAMES):
        c = torch.from_numpy(cands).to(card)
        before = kernels.LAUNCHES["alloc_sweep"]
        got = bitalloc_kernels.alloc_sweep(c)
        assert kernels.LAUNCHES["alloc_sweep"] == before + 1
        assert torch.equal(got, bitalloc_kernels.alloc_sweep_plain(c)), name
        assert np.array_equal(got.cpu().numpy(), testing.sweep_reference(cands, bitalloc_kernels.RDO_BUDGET)), name


@pytest.mark.cuda
def test_alloc_sweep_kernel_on_both_allocators_candidates(card):
    rng = np.random.default_rng(6)
    sf = torch.from_numpy(rng.integers(0, 64, (300, 52)).astype(np.int32)).to(card)
    bfu = torch.from_numpy((rng.standard_normal((300, 52, 20)) * 0.3).astype(np.float32)).to(card)
    for cands in (bitalloc.reference_candidates(sf, 1.0), bitalloc.rdo_candidates(bfu, sf, 2.0)):
        cands = cands.contiguous()
        assert torch.equal(bitalloc_kernels.alloc_sweep(cands), bitalloc_kernels.alloc_sweep_plain(cands))
    assert torch.equal(bitalloc.allocate_bits(sf, 0.7), bitalloc.allocate_bits(sf, 0.7, plain=True))


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
    assert all(kernels.LAUNCHES[k] > 0 for k in ("alloc_sweep", "read_fields", "qmf_taps", "imdct_exact_256")), \
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


@pytest.mark.parametrize(
    "call",
    [
        lambda: bitalloc_kernels.alloc_sweep(torch.zeros(4, 780, dtype=torch.int64)),
        lambda: bitalloc_kernels.alloc_sweep(torch.zeros(780, dtype=torch.int32)),
        lambda: bitalloc_kernels.alloc_sweep(torch.zeros(780, 4, dtype=torch.int32).T),
        lambda: imdct_kernels.imdct_mid(torch.zeros(4, 32, dtype=torch.float64), 64),
        lambda: imdct_kernels.imdct_mid(torch.zeros(4, 33), 64),
        lambda: imdct_kernels.imdct_mid(torch.zeros(4, 64), 128),
        lambda: imdct_kernels.imdct_mid(torch.zeros(64, 4).T, 64),
        lambda: qmf_kernels.qmf_taps(torch.zeros(4, 45)),
        lambda: bitpack_kernels.read_fields(
            torch.zeros(2, 128, dtype=torch.int32), torch.zeros(3, 5, dtype=torch.int32),
            torch.zeros(3, 5, dtype=torch.int32), 13, 107,
        ),
    ],
)
def test_kernel_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()
