"""BFU word lengths, quantizer ranges and the BFU -> spectrum scatter.

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
