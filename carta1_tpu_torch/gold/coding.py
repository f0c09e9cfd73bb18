"""The exact encoder's scale factors, quantizer and bit allocation.

The port of `carta1_tpu/gold/coding.py` (codec/coding/bitallocation.js,
codec/coding/quantization.js).  Scale factors come from
`ops/coding.find_scale_factors`, whose f64 table comparison equals gold's
ceil(3 * (log2(a) + 21)); the allocation is the reference's heap, kernel
K5 (`ops/heap_kernels.py`); the quantizer is gold's f64 one (the batched
engine's `ops/coding.quantize` is f32 and differs).
"""

from __future__ import annotations

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops.coding import _encode_tables, find_scale_factors, quant_range
from carta1_tpu_torch.ops.heap_kernels import alloc_heap, alloc_heap_plain

__all__ = ["allocate_bits", "find_scale_factors", "quantize_js"]


def quantize_js(coeffs: torch.Tensor, sf_idx: torch.Tensor, word_len: torch.Tensor) -> torch.Tensor:
    """Midtread quantizer, round half away from zero by truncation
    (quantization.js:34-56): f32 [..., 52, 20] -> int32.

    norm = range / sf in f64, x = coeffs * norm, y = trunc(x +- 0.5),
    clamped to +-range; 0 where the word length or the scale factor is 0.
    The clamp comes before the conversion to int32, with the same result."""
    rng = quant_range(word_len)
    active = (rng > 0) & (sf_idx > 0)
    sf = _encode_tables(coeffs.device)["sf64"][sf_idx.long()]
    rng_f = rng.double()
    norm = torch.where(active, rng_f / torch.where(sf > 0, sf, 1.0), 0.0).unsqueeze(-1)
    x = coeffs.double() * norm
    y = torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))
    y = torch.clamp(y, -rng_f.unsqueeze(-1), rng_f.unsqueeze(-1))
    return torch.where(active.unsqueeze(-1), y, 0.0).to(torch.int32)


def allocate_bits(sf_idx: torch.Tensor, allocation_bias: float, plain: bool = False) -> torch.Tensor:
    """The reference's heap allocation of every frame: int32 [..., 52] scale
    factor indices -> int32 [..., 52] word lengths.  Kernel K5 on the card,
    its plain version on the CPU or with `plain=True`."""
    flat = sf_idx.reshape(-1, C.NUM_BFUS).contiguous()
    alloc = alloc_heap_plain if plain else alloc_heap
    return alloc(flat, allocation_bias).reshape(sf_idx.shape)
