"""BFU grouping and scatter, scale factors, quantizer and dequantizer.

Parity: codec/coding/quantization.js.  Where the JAX package uses one-hot
contractions and static concatenations (gathers are slow on the TPU), the
port indexes directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C

_NSLOT = C.NUM_BFUS * C.MAX_BFU_SIZE                   # 1040
# band of each of the 512 coefficient positions: 0, 1 or 2
_POS_BAND = np.minimum(np.arange(C.SAMPLES_PER_FRAME) // 128, 2)
assert (C.BFU_SCATTER_IDX >= 0).all(), "BFU runs must tile the spectrum in both modes"


@functools.lru_cache(maxsize=None)
def _index_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    scatter = torch.from_numpy(C.BFU_SCATTER_IDX.astype(np.int64)).to(device)   # [2, 512]
    pos_band = torch.from_numpy(_POS_BAND.astype(np.int64)).to(device)          # [512]
    return scatter, pos_band


@functools.lru_cache(maxsize=None)
def _encode_tables(device: torch.device) -> dict[str, torch.Tensor]:
    gather = C.BFU_GATHER_IDX.reshape(2, _NSLOT)
    return {
        "gather": torch.from_numpy(np.maximum(gather, 0).astype(np.int64)).to(device),   # [2, 1040]
        "filled": torch.from_numpy(gather >= 0).to(device),                              # [2, 1040]
        "bfu_band": torch.from_numpy(C.BFU_BAND.astype(np.int64)).to(device),            # [52]
        "slot_mask": torch.from_numpy(C.BFU_SLOT_MASK).to(device),                       # [52, 20]
        "sf64": torch.from_numpy(C.SCALE_FACTORS).to(device),                            # [64] f64
        "sf32": torch.from_numpy(C.SCALE_FACTORS.astype(np.float32)).to(device),         # [64] f32
    }


def word_length_bits(wl: torch.Tensor) -> torch.Tensor:
    """WORD_LENGTH_BITS[wl] in closed form: 0, then wl+1 (constants.js:141)."""
    return torch.where(wl > 0, wl + 1, 0)


def quant_range(wl: torch.Tensor) -> torch.Tensor:
    """(1 << (bits-1)) - 1, 0 at wl == 0 (quantization.js:43)."""
    bits = word_length_bits(wl)
    return torch.where(bits > 0, (1 << (bits - 1).clamp(min=0)) - 1, 0)


def scatter_bfus(values: torch.Tensor, modes: torch.Tensor, n_bfu: torch.Tensor) -> torch.Tensor:
    """[..., 52, 20] BFU slot values -> [..., 512] spectra (decoder.js:52-98).

    Each coefficient position is copied from the slot its band's block mode
    maps to (`BFU_SCATTER_IDX`); BFUs at or beyond n_bfu give silence."""
    scatter, pos_band = _index_tables(values.device)
    active = torch.arange(C.NUM_BFUS, device=values.device) < n_bfu.unsqueeze(-1)
    vals = torch.where(active.unsqueeze(-1), values, 0.0).reshape(*values.shape[:-2], _NSLOT)
    long_out = vals[..., scatter[0]]
    short_out = vals[..., scatter[1]]
    pos_short = modes[..., pos_band] != 0
    return torch.where(pos_short, short_out, long_out)


def expand_band_to_bfu(per_band: torch.Tensor) -> torch.Tensor:
    """[..., 3] band values -> [..., 52] per-BFU values."""
    return per_band[..., _encode_tables(per_band.device)["bfu_band"]]


def expand_band_to_coeff(per_band: torch.Tensor) -> torch.Tensor:
    """[..., 3] band values -> [..., 512] per-position values."""
    return per_band[..., _index_tables(per_band.device)[1]]


def group_bfus(coeffs: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """[..., 512] spectra -> [..., 52, 20] BFU slots (zero padding).

    quantization.js:106-149: a slot's position depends on the block mode of
    the band that owns it; slots past a BFU's size, or outside its band,
    are zero.  One gather per block mode, then a select."""
    t = _encode_tables(coeffs.device)
    long_slots = torch.where(t["filled"][0], coeffs[..., t["gather"][0]], 0.0)        # [..., 1040]
    short_slots = torch.where(t["filled"][1], coeffs[..., t["gather"][1]], 0.0)
    slot_short = (expand_band_to_bfu(modes) != 0).repeat_interleave(C.MAX_BFU_SIZE, dim=-1)
    out = torch.where(slot_short, short_slots, long_slots)
    return out.reshape(*coeffs.shape[:-1], C.NUM_BFUS, C.MAX_BFU_SIZE)


def find_scale_factors(bfu_data: torch.Tensor) -> torch.Tensor:
    """[..., 52, 20] -> int32 [..., 52] (bitallocation.js:172-181).

    The reference takes ceil(3 * (log2(a) + 21)) in f64: the smallest index
    whose table value 2^(i/3 - 21) is at least the BFU's peak a.  A peak at
    or next to a table value sits on that ceil's boundary, where an f32
    log2 decides by its last ulp, and differently from one math library to
    the next; so the index is read off the f64 table itself (a bucketize),
    which needs no logarithm and agrees with the gold engine on every f32
    value within 4 ulps of each table entry (tests/test_torch_encode.py)."""
    t = _encode_tables(bfu_data.device)
    max_amp = torch.where(t["slot_mask"], bfu_data.abs(), 0.0).amax(dim=-1)
    idx = torch.bucketize(max_amp.double(), t["sf64"]).clamp(max=63)
    return torch.where(max_amp > 0, idx, 0).to(torch.int32)


def quantize(bfu_data: torch.Tensor, sf_idx: torch.Tensor, word_len: torch.Tensor) -> torch.Tensor:
    """Midtread quantizer, round half away from zero, then clamp
    (quantization.js:42-55).  [..., 52, 20] -> int32.

    norm = range / sf is one f32 division of the f32 scale-factor table
    value, as in `carta1_tpu/ops/coding.py` `quantize`.  The clamp comes
    before the conversion to int32 (a float beyond int32 has no defined
    conversion in PyTorch); the result is the same."""
    sf = _encode_tables(bfu_data.device)["sf32"][sf_idx.long()]                 # [..., 52]
    rng = quant_range(word_len)
    active = (rng > 0) & (sf_idx > 0)
    rng_f = rng.to(torch.float32)
    norm = torch.where(active, rng_f / torch.where(sf > 0, sf, 1.0), 0.0).unsqueeze(-1)
    x = bfu_data * norm
    y = torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))
    return torch.clamp(y, -rng_f.unsqueeze(-1), rng_f.unsqueeze(-1)).to(torch.int32)


def dequantize(quantized: torch.Tensor, sf_idx: torch.Tensor, word_len: torch.Tensor) -> torch.Tensor:
    """int32 [..., 52, 20] -> f32 (quantization.js:65-78); step = sf / range
    as one f32 division.  The encoder's own inverse (the allocator prices
    steps with it); the decoder's is `ops.exact_decode.dequantize_exact`."""
    sf = _encode_tables(quantized.device)["sf32"][sf_idx.long()]
    rng = quant_range(word_len)
    active = (rng > 0) & (sf_idx > 0)
    step = torch.where(active, sf / rng.clamp(min=1).to(torch.float32), 0.0).unsqueeze(-1)
    return quantized.to(torch.float32) * step
