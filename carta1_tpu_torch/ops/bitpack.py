"""Batched sound-unit pack and unpack on the device.

Bit layout parity: codec/io/serialization.js:41-176 (MSB first,
two's-complement coefficients); semantics of `carta1_tpu/io/bitstream_np.py`
`pack_frames` (each frame laid out for its own nBfu, as the host packer
lays it out; the JAX device pack knows nBfu = 52 only) and
`carta1_tpu/ops/bitpack.py` `unpack_frames`, including all eight
BFU_AMOUNTS and the truncated-field rule for malformed units
(bitstream.js:55).

The unit is viewed as 106 big-endian halfwords padded to 128; a field of
width <= 16 at bit offset r in [0, 16) of halfword h lies inside the
32-bit window (half[h] << 16) | half[h+1].  Word lengths sit at static
offsets 16 + 4i (nibbles of halfwords 1..13); scale factors start at
16 + 4 nBfu (anchors in [6, 34)); coefficients at 16 + 10 nBfu (anchors
in [13, 107)).  Both dynamic reads go through kernel K3
(`ops/bitpack_kernels.read_fields`).

Packing on the card is kernel K7 (`bitpack_kernels.pack_units`): one warp
a frame ORs every field into the unit's 53 words in shared memory.  Its
plain version, `pack_frames_plain`, runs the same windows as the unpack
the other way: every field (header, word lengths, scale factors,
coefficients) is shifted into place inside the 32-bit window anchored at
its halfword, and the windows of a unit are summed per anchor; the offsets
and widths are per frame, from its nBfu.  Fields never share a bit, so the
sum is exact in any order (one integer `scatter_add_`, where the JAX
package selects and sums over [F, 1040, 74] because the TPU runtime has no
fast scatter).  PyTorch has no uint32 arithmetic; windows are held in int64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.ops import bitpack_kernels
from carta1_tpu_torch.ops.coding import word_length_bits

_NF = C.NUM_BFUS
_NS = C.MAX_BFU_SIZE
_NHALF = C.SOUND_UNIT_SIZE // 2               # 106 halfwords per unit
_NHALF_PAD = bitpack_kernels.N_ANCHORS        # 128

_DUMP = _NHALF                                # window column of fields anchored past the unit

_SF_J = (6, 34)
_COEFF_J = (13, _NHALF + 1)            # [13, 107): +1 for the straddle window


@functools.lru_cache(maxsize=None)
def _slot_mask(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(C.BFU_SLOT_MASK).to(device)


@functools.lru_cache(maxsize=None)
def _pack_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """BFU_AMOUNTS, the BFU index i, the word lengths' bit offsets 16 + 4i
    and the scale factors' steps 6i: int64 [8], [52], [52], [52]."""
    i = torch.arange(_NF, device=device)
    return (torch.from_numpy(C.BFU_AMOUNTS.astype(np.int64)).to(device), i, C.FRAME_HEADER_BITS + 4 * i, 6 * i)


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


def pack_frames(fd: FrameData, plain: bool = False) -> torch.Tensor:
    """FrameData [..., F, ...] -> uint8 [..., F, 212], each frame laid out for
    its own n_bfu: the header's BFU-amount index is
    searchsorted(BFU_AMOUNTS, n_bfu) (left side, so n_bfu 0 writes index 0
    and packs to C.SILENT_UNIT), word lengths at 16 + 4i, scale factors at
    16 + 4 n_bfu + 6i, coefficients from 16 + 10 n_bfu, and the fields of
    BFUs at or past n_bfu hold no bits.  Bytes equal
    `carta1_tpu/io/bitstream_np.pack_frames`' for n_bfu in [0, 52] and word
    lengths in [0, 15]; other values give unspecified bytes, as there, and
    are not checked (a check would cost a host sync).

    CUDA tensors launch K7 (`bitpack_kernels.pack_units`, int32 fields);
    CPU tensors, or `plain=True` on any device, run `pack_frames_plain`
    (the yardstick the kernel is held against)."""
    if plain or fd.word_lengths.device.type == "cpu":
        return pack_frames_plain(fd)
    lead = fd.word_lengths.shape[:-1]
    fields = (getattr(fd, name).reshape(-1, *tail).contiguous() for name, tail in bitpack_kernels.PACK_FIELDS)
    return bitpack_kernels.pack_units(*fields).reshape(*lead, C.SOUND_UNIT_SIZE)


def pack_frames_plain(fd: FrameData) -> torch.Tensor:
    """`pack_frames` in plain PyTorch on any device: every field of a unit
    in int64 [N, 1145] columns, summed into 32-bit windows by one
    `scatter_add_`."""
    lead = fd.word_lengths.shape[:-1]
    dev = fd.word_lengths.device
    nb = fd.n_bfu.reshape(-1, 1).long()                                        # [N, 1]
    wl = fd.word_lengths.reshape(-1, _NF).long()
    sf = fd.scale_factors.reshape(-1, _NF).long()
    q = fd.quantized.reshape(-1, _NF * _NS).long()
    modes = fd.block_modes.reshape(-1, 3).long()
    n = wl.shape[0]
    amounts, i, wl_off, sf_step = _pack_tables(dev)
    active = i < nb                                                            # [N, 52]

    header = (((2 - modes[:, :1]) << 14) | ((2 - modes[:, 1:2]) << 12) | ((3 - modes[:, 2:]) << 10)
              | (torch.searchsorted(amounts, nb) << 5))                          # [N, 1]

    widths_bfu = torch.where(active, word_length_bits(wl), 0)                  # [N, 52]
    flat_w = torch.where(_slot_mask(dev), widths_bfu[:, :, None], 0).reshape(n, _NF * _NS)
    coeff_off = C.FRAME_HEADER_BITS + 10 * nb + torch.cumsum(flat_w, dim=1) - flat_w   # [N, 1040]

    # every field of a unit: value, bit offset, width (a width of 0 holds no
    # bits); each value keeps its low `width` bits, two's complement for the
    # coefficients
    offs = torch.cat([torch.zeros_like(nb), wl_off.expand(n, -1), sf_step + (C.FRAME_HEADER_BITS + 4 * nb), coeff_off],
                     dim=1)                                                    # [N, 1145]
    widths = torch.cat([torch.full_like(nb, 16), 4 * active, 6 * active, flat_w], dim=1)
    vals = torch.cat([header, wl, sf, q], dim=1) & ((1 << widths) - 1)

    # the field inside the 32-bit window anchored at its halfword; the shift
    # is at most 31 (a width of 0 is shifted as 1 and carries the value 0)
    aligned = vals << (32 - (offs & 15) - widths.clamp(min=1))
    # anchors past the unit are dropped (the reference stops at the buffer
    # end, bitstream.js:24): they land in a column that is never read.  Only
    # an n_bfu below 0 gives offsets below 0, all of fields of width 0.
    anchor = (offs >> 4).clamp(0, _DUMP)
    win = torch.zeros((n, _DUMP + 1), dtype=torch.int64, device=dev)
    win.scatter_add_(1, anchor, aligned)

    # window j covers halfwords (j, j + 1); bit-disjoint fields recombine carry-free
    half = (win[:, :_NHALF] >> 16) | torch.cat(
        [torch.zeros_like(win[:, :1]), win[:, : _NHALF - 1] & 0xFFFF], dim=1
    )
    units = torch.stack([half >> 8, half & 0xFF], dim=-1).reshape(n, C.SOUND_UNIT_SIZE)
    return units.to(torch.uint8).reshape(*lead, C.SOUND_UNIT_SIZE)
