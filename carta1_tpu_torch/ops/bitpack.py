"""Batched sound-unit unpack on the device.

Bit layout parity: codec/io/serialization.js:111-176 (MSB first,
two's-complement coefficients); semantics of `carta1_tpu/ops/bitpack.py`
`unpack_frames`, including all eight BFU_AMOUNTS and the truncated-field
rule for malformed units (bitstream.js:55).

The unit is viewed as 106 big-endian halfwords padded to 128; a field of
width <= 16 at bit offset r in [0, 16) of halfword h lies inside the
32-bit window (half[h] << 16) | half[h+1].  Word lengths sit at static
offsets 16 + 4i (nibbles of halfwords 1..13); scale factors start at
16 + 4 nBfu (anchors in [6, 34)); coefficients at 16 + 10 nBfu (anchors
in [13, 107)).  Both dynamic reads go through kernel K3
(`ops/bitpack_kernels.read_fields`).
"""

from __future__ import annotations

import functools

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.ops import bitpack_kernels
from carta1_tpu_torch.ops.coding import word_length_bits

_NF = C.NUM_BFUS
_NS = C.MAX_BFU_SIZE
_NHALF = C.SOUND_UNIT_SIZE // 2               # 106 halfwords per unit
_NHALF_PAD = bitpack_kernels.N_ANCHORS        # 128

_SF_J = (6, 34)
_COEFF_J = (13, _NHALF + 1)            # [13, 107): +1 for the straddle window


@functools.lru_cache(maxsize=None)
def _slot_mask(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(C.BFU_SLOT_MASK).to(device)


def _halfwords(units: torch.Tensor) -> torch.Tensor:
    """uint8 [N, 212] -> big-endian halfwords int64 [N, 128] (zero padded)."""
    b = torch.zeros((units.shape[0], 2 * _NHALF_PAD), dtype=torch.int64, device=units.device)
    b[:, : C.SOUND_UNIT_SIZE] = units
    return (b[:, 0::2] << 8) | b[:, 1::2]


def _windows(half: torch.Tensor) -> torch.Tensor:
    """[N, 128] halfwords -> int32 [N, 128] holding the uint32 window bits
    (half[j] << 16) | half[j+1]."""
    shifted = torch.cat([half[:, 1:], torch.zeros_like(half[:, :1])], dim=1)
    w = (half << 16) | shifted
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _layout(u: torch.Tensor) -> dict:
    """Everything of [N, 212] units that needs no dynamic read: the header
    fields, the word lengths, the windows and both reads' offsets/widths."""
    n = u.shape[0]
    dev = u.device
    half = _halfwords(u)                                             # [N, 128]
    header = half[:, 0]
    block_modes = torch.stack(
        [2 - ((header >> 14) & 3), 2 - ((header >> 12) & 3), 3 - ((header >> 10) & 3)], dim=1
    )
    amount_idx = (header >> 5) & 7
    # BFU_AMOUNTS closed form: [20, 28, 32, 36, 40, 44, 48, 52]
    n_bfu = torch.where(amount_idx > 0, 4 * amount_idx + 24, 20)

    i = torch.arange(_NF, device=dev)
    active = i < n_bfu[:, None]

    # word lengths: static 4-bit fields at bits 16+4i = nibbles of halfwords 1..13
    nib = torch.arange(4, device=dev)
    wl_all = ((half[:, 1:1 + _NF // 4, None] >> (12 - 4 * nib)) & 15).reshape(n, _NF)
    word_lengths = torch.where(active, wl_all, 0)

    widths = torch.where(active, word_length_bits(word_lengths), 0)            # [N, 52]
    flat_w = torch.where(_slot_mask(dev), widths[:, :, None], 0).reshape(n, _NF * _NS)
    coeff_off = C.FRAME_HEADER_BITS + 10 * n_bfu[:, None] + torch.cumsum(flat_w, dim=1) - flat_w
    sf_off = C.FRAME_HEADER_BITS + 4 * n_bfu[:, None] + 6 * i
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return {
        "n_bfu": n_bfu, "block_modes": block_modes, "active": active,
        "word_lengths": word_lengths, "flat_w": flat_w,
        "reads": [
            (i32(sf_off), i32(torch.full_like(sf_off, 6)), *_SF_J),
            (i32(coeff_off), i32(flat_w), *_COEFF_J),
        ],
        "win32": _windows(half),
    }


def field_reads(units: torch.Tensor) -> list[tuple]:
    """The two K3 calls that unpacking uint8 [N, 212] units makes, as
    (win32, offsets, widths, j_lo, j_hi): the scale factors (M = 52) and
    the coefficients (M = 1040)."""
    lay = _layout(units)
    return [(lay["win32"], *r) for r in lay["reads"]]


def unpack_frames(units: torch.Tensor, plain: bool = False) -> FrameData:
    """uint8 [..., F, 212] -> FrameData [..., F, ...] (honors every BFU_AMOUNTS value).

    `plain=True` runs K3's plain PyTorch version on any device (the
    yardstick the kernel is held against)."""
    if units.dtype != torch.uint8 or units.shape[-1] != C.SOUND_UNIT_SIZE:
        raise ValueError(f"unpack_frames: need uint8 [..., F, 212], got {units.dtype} {tuple(units.shape)}")
    lead = units.shape[:-1]
    u = units.reshape(-1, C.SOUND_UNIT_SIZE)
    lay = _layout(u)
    read = bitpack_kernels.read_fields_plain if plain else bitpack_kernels.read_fields
    sf_read, coeff_read = lay["reads"]

    scale_factors = torch.where(lay["active"], read(lay["win32"], *sf_read), 0)
    flat_w = lay["flat_w"]
    vals = read(lay["win32"], *coeff_read).long()                             # [N, 1040]
    sign_bit = torch.where(flat_w > 0, 1 << (flat_w - 1).clamp(min=0), 0)
    vals = torch.where(vals >= sign_bit.clamp(min=1), vals - (sign_bit << 1), vals)
    quantized = torch.where(flat_w > 0, vals, 0).reshape(u.shape[0], _NF, _NS)

    def out(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.int32).reshape(*lead, *x.shape[1:])

    return FrameData(
        n_bfu=out(lay["n_bfu"]),
        block_modes=out(lay["block_modes"]),
        scale_factors=out(scale_factors),
        word_lengths=out(lay["word_lengths"]),
        quantized=out(quantized),
    )
