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

from carta1_tpu_torch import decode_units, kernels
from carta1_tpu_torch.io.aea import read_aea
from carta1_tpu_torch.ops import bitpack, bitpack_kernels, imdct_kernels, qmf_kernels

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


@pytest.mark.parametrize(
    "call",
    [
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
