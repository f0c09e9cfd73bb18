"""Sound units <-> fields, as the reference reads and writes them
(codec/io/serialization.js:41-176, bitstream.js): MSB first within each
byte, a 16-bit header (three block modes and the BFU amount), 4-bit word
lengths and 6-bit scale factors of the first n_bfu BFUs, then each BFU's
coefficients in its word length, two's complement.

Both directions work on whole bit planes ([frames, 1696] of 0/1), so
they take frames in blocks to bound the memory.
"""

from __future__ import annotations

import torch

from benchmark.reference import tables as T

BLOCK = 4096          # frames per block of the bit planes


def _layout(n_bfu: torch.Tensor, wl: torch.Tensor):
    """(sf offset [F, 52], coefficient offset [F, 52, 20], width [F, 52],
    BFU active [F, 52]) of every field, for word lengths wl [F, 52]."""
    dev = wl.device
    i = torch.arange(T.NUM_BFUS, device=dev)
    active = i < n_bfu[:, None]
    sf_off = 16 + 4 * n_bfu[:, None] + 6 * i
    width = torch.where(active, T.on("WORD_LENGTH_BITS", dev)[wl], 0)
    field = width * T.on("SPECS_PER_BFU", dev)
    start = 16 + 10 * n_bfu[:, None] + torch.cumsum(field, 1) - field
    k = torch.arange(T.MAX_BFU_SIZE, device=dev)
    return sf_off, start[..., None] + k * width[..., None], width, active


def modes(units: torch.Tensor) -> torch.Tensor:
    """The block modes [..., 3] that the headers of units [..., 212] carry:
    0 for a long block; 2, 2 and 3 for the bands' short modes."""
    header = (units[..., 0].long() << 8) | units[..., 1].long()
    return torch.stack([2 - ((header >> 14) & 3), 2 - ((header >> 12) & 3), 3 - ((header >> 10) & 3)], -1)


def unpack(units: torch.Tensor) -> dict[str, torch.Tensor]:
    """uint8 [F, 212] -> fields: n_bfu [F], modes [F, 3], wl, sf [F, 52],
    q [F, 52, 20] (int64).  A field that runs past the unit's end keeps the
    bits that are there (bitstream.js:55); slots past a BFU's size are 0."""
    parts = [_unpack_block(units[s:s + BLOCK]) for s in range(0, units.shape[0], BLOCK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _unpack_block(units: torch.Tensor) -> dict[str, torch.Tensor]:
    dev = units.device
    nf = units.shape[0]
    shifts = torch.arange(7, -1, -1, device=dev)
    bits = ((units.long()[..., None] >> shifts) & 1).reshape(nf, T.FRAME_BITS)
    bits = torch.cat([bits, torch.zeros((nf, 1), dtype=torch.long, device=dev)], 1)   # reads past the end give 0

    def read(offsets: torch.Tensor, width: torch.Tensor | int) -> torch.Tensor:
        """Unsigned fields at bit offsets [F, ...] of `width` bits (at most 16),
        cut where the unit ends."""
        width = torch.as_tensor(width, device=dev).expand_as(offsets)
        eff = torch.clamp(T.FRAME_BITS - offsets, min=0).minimum(width)
        j = torch.arange(16, device=dev)
        inside = j < eff[..., None]
        pos = torch.where(inside, offsets[..., None] + j, T.FRAME_BITS).clamp(0, T.FRAME_BITS)
        got = torch.gather(bits, 1, pos.reshape(nf, -1)).reshape(pos.shape)
        return (torch.where(inside, got << (eff[..., None] - 1 - j).clamp(min=0), 0)).sum(-1)

    header = read(torch.zeros((nf, 1), dtype=torch.long, device=dev), 16)[:, 0]
    modes = torch.stack([2 - ((header >> 14) & 3), 2 - ((header >> 12) & 3), 3 - ((header >> 10) & 3)], 1)
    n_bfu = T.on("BFU_AMOUNTS", dev)[(header >> 5) & 7]
    i = torch.arange(T.NUM_BFUS, device=dev)
    active = i < n_bfu[:, None]
    wl = torch.where(active, read(16 + 4 * i.expand(nf, -1), 4), 0)
    sf_off, c_off, width, _ = _layout(n_bfu, wl)
    sf = torch.where(active, read(sf_off, 6), 0)
    slot = T.on("SLOT_MASK", dev) & (width[..., None] > 0)
    w = width[..., None].expand_as(c_off)
    raw = read(c_off, w)
    sign = torch.where(slot, 1 << (w - 1).clamp(min=0), 0)
    q = torch.where((raw >= sign) & (sign > 0), raw - (sign << 1), raw)
    return {"n_bfu": n_bfu, "modes": modes, "wl": wl, "sf": sf, "q": torch.where(slot, q, 0)}


def pack(fields: dict[str, torch.Tensor]) -> torch.Tensor:
    """fields (as `unpack` gives them) -> uint8 [F, 212]; bits past the
    unit's end are dropped, as the reference's writer drops them."""
    nf = fields["n_bfu"].shape[0]
    parts = [_pack_block({k: v[s:s + BLOCK] for k, v in fields.items()}) for s in range(0, nf, BLOCK)]
    return torch.cat(parts)


def _pack_block(f: dict[str, torch.Tensor]) -> torch.Tensor:
    dev = f["n_bfu"].device
    nf = f["n_bfu"].shape[0]
    bits = torch.zeros((nf, T.FRAME_BITS + 1), dtype=torch.long, device=dev)    # last column: what is dropped
    rows = torch.arange(nf, device=dev)

    def put(values: torch.Tensor, offsets: torch.Tensor, width: torch.Tensor | int, mask: torch.Tensor) -> None:
        width = torch.as_tensor(width, device=dev).expand_as(offsets)
        j = torch.arange(16, device=dev)
        ok = mask[..., None] & (j < width[..., None])
        pos = torch.where(ok, offsets[..., None] + j, T.FRAME_BITS).clamp(max=T.FRAME_BITS)
        bit = (values[..., None] >> (width[..., None] - 1 - j).clamp(min=0)) & 1
        idx = rows.reshape(nf, *([1] * (pos.dim() - 1))).expand_as(pos)
        bits.index_put_((idx[ok], pos[ok]), bit[ok])

    amount = torch.searchsorted(T.on("BFU_AMOUNTS", dev), f["n_bfu"])
    m = f["modes"]
    header = ((2 - m[:, 0]) << 14) | ((2 - m[:, 1]) << 12) | ((3 - m[:, 2]) << 10) | (amount << 5)
    first = torch.zeros((nf, 1), dtype=torch.long, device=dev)
    put(header[:, None], first, 16, first == 0)
    i = torch.arange(T.NUM_BFUS, device=dev)
    sf_off, c_off, width, active = _layout(f["n_bfu"], f["wl"])
    put(f["wl"], 16 + 4 * i.expand(nf, -1), 4, active)
    put(f["sf"], sf_off, 6, active)
    w = width[..., None].expand_as(c_off)
    slot = T.on("SLOT_MASK", dev) & (w > 0)
    put(f["q"] & ((1 << w.clamp(min=1)) - 1), c_off, w, slot)
    planes = bits[:, :T.FRAME_BITS].reshape(nf, T.SOUND_UNIT_SIZE, 8)
    return (planes << torch.arange(7, -1, -1, device=dev)).sum(-1).to(torch.uint8)
