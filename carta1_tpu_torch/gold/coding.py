"""The exact encoder's scale factors, quantizer and bit allocation.

The port of `carta1_tpu/gold/coding.py` (codec/coding/bitallocation.js,
codec/coding/quantization.js), with gold's signatures.  Scale factors are
read off the f64 table (`ops/coding.find_scale_factors`'s comparison,
equal to gold's ceil(3 * (log2(a) + 21))); the allocation is the
reference's heap, kernel K5 (`ops/heap_kernels.py`); gold's sorted-sweep
spec of the batched engine's reference allocator is kernel K4's
`alloc_reference` (`ops/bitalloc_kernels.py`); the quantizer is gold's f64
one (the batched engine's `ops/coding.quantize` is f32 and differs) and
the dequantizer the exact decoder's.

K4 and K5 are built for the codec's BFU sizes (`SPECS_PER_BFU`): the
allocators take gold's `bfu_sizes` argument and raise on any other.  Each
runs its kernel for a tensor on the card and the kernel's plain version
for a CPU tensor or with `plain=True`.
"""

from __future__ import annotations

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops.bitalloc_kernels import alloc_reference, alloc_reference_plain
from carta1_tpu_torch.ops.coding import _encode_tables, quant_range
from carta1_tpu_torch.ops.exact_decode import dequantize_exact
from carta1_tpu_torch.ops.heap_kernels import alloc_heap, alloc_heap_plain

__all__ = [
    "allocate_bits", "allocate_bits_frame", "allocate_bits_sf", "allocate_bits_sweep", "dequantize_js",
    "find_scale_factors", "quantize_js",
]


def find_scale_factors(bfu_data: torch.Tensor, slot_mask=None) -> torch.Tensor:
    """Per-BFU scale factor index (bitallocation.js:172-181): f32
    [..., 52, 20] and a bool slot mask broadcastable to it (None: the
    codec's slots, `BFU_SLOT_MASK`) -> int32 [..., 52]; 0 where the BFU's
    masked slots are all zero.

    The index is the smallest whose table value 2^(i/3 - 21) is at least
    the BFU's peak (a bucketize of the f64 table, as `ops/coding.py` reads
    it), clamped to 63: gold's ceil(3 * (log2(a) + 21)) clipped to
    [0, 63], which also gives 63 for a NaN peak."""
    if slot_mask is None:
        mask = _encode_tables(bfu_data.device)["slot_mask"]
    else:
        mask = torch.as_tensor(np.asarray(slot_mask.cpu() if isinstance(slot_mask, torch.Tensor) else slot_mask,
                                          bool), device=bfu_data.device)
    max_amp = torch.where(mask, bfu_data.abs(), 0.0).amax(dim=-1)
    idx = torch.bucketize(max_amp.double(), _encode_tables(bfu_data.device)["sf64"]).clamp(max=63)
    idx = torch.where(max_amp.isnan(), 63, idx)
    return torch.where(max_amp == 0.0, 0, idx).to(torch.int32)


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


def dequantize_js(quantized: torch.Tensor, sf_idx: torch.Tensor, word_len: torch.Tensor) -> torch.Tensor:
    """Inverse quantizer (quantization.js:65-78): int32 [..., 52, 20] ->
    f32, f64 compute and one f32 store; the exact decoder's."""
    return dequantize_exact(quantized, sf_idx, word_len)


def allocate_bits_sf(sf_idx: torch.Tensor, allocation_bias: float, plain: bool = False) -> torch.Tensor:
    """The reference's heap allocation of every frame: int32 [..., 52] scale
    factor indices -> int32 [..., 52] word lengths.  Kernel K5 on the card,
    its plain version on the CPU or with `plain=True`."""
    flat = sf_idx.reshape(-1, C.NUM_BFUS).to(torch.int32).contiguous()
    alloc = alloc_heap_plain if plain else alloc_heap
    return alloc(flat, allocation_bias).reshape(sf_idx.shape)


def _check_sizes(bfu_sizes, name: str) -> None:
    sizes = np.asarray(bfu_sizes.cpu() if isinstance(bfu_sizes, torch.Tensor) else bfu_sizes)
    if sizes.shape != C.SPECS_PER_BFU.shape or not np.array_equal(sizes, C.SPECS_PER_BFU):
        raise ValueError(f"{name}: kernels K4 and K5 are built for the codec's BFU sizes (SPECS_PER_BFU), "
                         f"got {sizes.tolist()}")


def allocate_bits(bfu_data: torch.Tensor, bfu_sizes, allocation_bias: float,
                  plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's greedy allocation of every frame, gold's batched
    entry: f32 [F, 52, 20] BFU data, the codec's BFU sizes and a bias ->
    (word lengths int32 [F, 52], scale factor indices int32 [F, 52]).  The
    scale factors of each BFU's first bfu_sizes[b] slots, then the heap
    (bitallocation.js:44-164) on kernel K5."""
    _check_sizes(bfu_sizes, "allocate_bits")
    if bfu_data.dim() != 3 or tuple(bfu_data.shape[1:]) != (C.NUM_BFUS, C.MAX_BFU_SIZE):
        raise ValueError(f"allocate_bits: need BFU data [F, {C.NUM_BFUS}, {C.MAX_BFU_SIZE}], got "
                         f"{tuple(bfu_data.shape)}")
    sf = find_scale_factors(bfu_data)
    return allocate_bits_sf(sf, allocation_bias, plain), sf


def allocate_bits_frame(bfu_data: torch.Tensor, bfu_sizes, allocation_bias: float,
                        plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """`allocate_bits` of one frame: f32 [52, 20] -> (word lengths int32
    [52], scale factor indices int32 [52])."""
    if bfu_data.dim() != 2:
        raise ValueError(f"allocate_bits_frame: need one frame's BFU data [{C.NUM_BFUS}, {C.MAX_BFU_SIZE}], got "
                         f"{tuple(bfu_data.shape)}")
    wl, sf = allocate_bits(bfu_data.unsqueeze(0), bfu_sizes, allocation_bias, plain)
    return wl[0], sf[0]


def allocate_bits_sweep(sf_table: torch.Tensor, bfu_sizes, allocation_bias: float,
                        plain: bool = False) -> torch.Tensor:
    """Gold's sorted-sweep formulation of the greedy allocation, the spec of
    the batched engine's reference allocator: int32 [F, 52] scale factor
    indices -> int32 [F, 52] word lengths.  Every step wl -> wl + 1 of every
    BFU with a scale factor, in descending f32 priority sf^bias * gain, ties
    in (BFU, word length) order, is taken while it fits, and a BFU whose
    step does not fit is abandoned.  Kernel K4's `alloc_reference` (its
    plain version for a CPU tensor, or with `plain=True`)."""
    _check_sizes(bfu_sizes, "allocate_bits_sweep")
    sf = sf_table.to(torch.int32).contiguous()
    return (alloc_reference_plain if plain else alloc_reference)(sf, allocation_bias)
