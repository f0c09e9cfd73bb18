"""Greedy rate-distortion bit allocation.

Exact reformulation of the reference's max-heap greedy
(codec/coding/bitallocation.js:78-164), as in `carta1_tpu/ops/bitalloc.py`:
per BFU the step priorities are non-increasing in word length, so the
heap's pop order equals one global descending-priority sweep over all
52 x 15 candidate steps with the heap's abandon-on-overflow rule (a BFU
whose next step does not fit is dropped and never revisited, while cheaper
steps of other BFUs continue).

On the card each allocator is one launch of kernel K4
(`ops/bitalloc_kernels.alloc_rdo` / `alloc_reference`), which merges the
52 per-BFU lists as the reference's heap does and never writes the
candidates.  The plain version, here and in `bitalloc_kernels`, is the JAX
package's formulation: the candidates of each frame ordered by one
`torch.sort` (the JAX package's `lax.sort`), packed
`bfu << 13 | cost << 1 | valid`, then the sweep
(`bitalloc_kernels.alloc_sweep_plain`).  It runs on the CPU and with
`plain=True`.

Spec of `allocate_bits` (matched exactly): gold.coding.allocate_bits_sweep.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.ops import bitalloc_kernels
from carta1_tpu_torch.tables import QUANT_RANGES, RDO_CAND_BFU, RDO_CAND_COST, RDO_STEP_BITS, RDO_STEP_GAIN

_NCAND = C.NUM_BFUS * 15
_PAYLOAD = (RDO_CAND_BFU << 13) | (RDO_CAND_COST << 1)        # [780] int32, valid bit clear
_INVALID_KEY = 0x7FFFFFFE                                     # sorts last; valid bit clear
_SF32 = C.SCALE_FACTORS.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    per_bit = 1.0 / (RDO_STEP_BITS * C.SPECS_PER_BFU[:, None]).astype(np.float32)      # [52, 15] f32
    return {
        "payload": torch.from_numpy(_PAYLOAD).to(device),
        "per_bit": torch.from_numpy(per_bit).to(device),
        "slot_mask": torch.from_numpy(C.BFU_SLOT_MASK).to(device),
        "sf32": torch.from_numpy(_SF32).to(device),
        "ranges": torch.from_numpy(QUANT_RANGES.astype(np.float32)).to(device),      # [16]
        # 0-dim operands of `where`: a Python scalar there costs a fill launch per call
        **{k: torch.tensor(v, dtype=torch.float32, device=device)
           for k, v in (("zero", 0.0), ("one", 1.0), ("half", 0.5), ("minus_half", -0.5))},
    }


@functools.lru_cache(maxsize=None)
def _rank_table(bias: float, device: torch.device) -> torch.Tensor:
    """int32 [64, 15]: descending rank of each (scale factor, step) priority
    sf32^bias * gain32, in the f32 semantics of the sweep spec; equal
    priorities share a rank."""
    prio = ((_SF32 ** np.float32(bias)).astype(np.float32)[:, None] * RDO_STEP_GAIN[None, :]).astype(np.float32)
    uniq = np.unique(prio)
    return torch.from_numpy((len(uniq) - 1 - np.searchsorted(uniq, prio)).astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _bias_weights(bias: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy((_SF32 ** np.float32(bias - 1.0)).astype(np.float32)).to(device)


def _running_max_from_right(x: torch.Tensor) -> torch.Tensor:
    """out[..., i] = max(x[..., i:]), the reverse `cummax` of the JAX code, as
    four doubling steps of `maximum` (exact in any order, NaN wherever a NaN
    lies at or right of i; `torch.cummax` over an innermost axis of 15 took
    8.4 ms per stereo chunk on the H100)."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = torch.maximum(x, torch.nn.functional.pad(x[..., k:], (0, k), value=float("-inf")))
        k *= 2
    return x


def quant_factors(sf32: torch.Tensor, sf_on: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(norm, step) f32 [..., 16]: the quantizer's scale and the dequantizer's
    step at every word length, op for op `ops.coding.quantize` and
    `dequantize`, for scale factors sf32 f32 [...] (zero where not sf_on).
    The kernel takes them as [64, 16] tables made by this same function."""
    t = _tables(sf32.device)
    active = sf_on.unsqueeze(-1) & (t["ranges"] > 0)
    norm = torch.where(active, t["ranges"] / torch.where(sf32 > 0, sf32, t["one"]).unsqueeze(-1), t["zero"])
    step = torch.where(active, sf32.unsqueeze(-1) / t["ranges"].clamp(min=1.0), t["zero"])
    return norm, step


def rdo_errors(bfu_data: torch.Tensor, sf_idx: torch.Tensor, allocation_bias: float) -> torch.Tensor:
    """Squared error of quantize + dequantize at each of the 16 word lengths,
    weighted for the bias: f32 [F, 52, 16].  bfu_data: f32 [F, 52, 20];
    sf_idx: int32 [F, 52].

    The 20 squared errors of a BFU are summed left to right in f32,
    acc = d_0^2, then acc = acc + d_k^2 for k = 1..19 (padding slots add an
    exact +0): the order `csrc/alloc_sweep.cu` repeats and
    `testing.rdo_errors_reference` pins."""
    t = _tables(sf_idx.device)
    bias = float(allocation_bias)
    sf32 = t["sf32"][sf_idx.long()]                                   # [F, 52]
    norm, step = quant_factors(sf32, sf_idx > 0)                      # [F, 52, 16] each

    # The coefficients go one word length at a time, so the temporaries stay
    # [F, 52, 20] and only the 16 error planes are kept.  A padding slot is
    # zeroed first and then quantizes to 0 with error 0: the same as masking
    # its error afterwards.
    data = torch.where(t["slot_mask"], bfu_data, t["zero"])
    planes = torch.empty((16, *sf_idx.shape), dtype=torch.float32, device=sf_idx.device)
    for wl in range(16):
        rng = float(QUANT_RANGES[wl])
        x = data * norm[..., wl:wl + 1]
        q = torch.trunc(x + torch.where(x >= 0, t["half"], t["minus_half"])).clamp(-rng, rng)
        d = data - q * step[..., wl:wl + 1]
        sq = d * d
        acc = sq[..., 0]
        for k in range(1, C.MAX_BFU_SIZE):
            acc = acc + sq[..., k]
        planes[wl] = acc
    err = planes.movedim(0, -1)                                       # [F, 52, 16]
    if bias != 1.0:
        # the reference's --bias semantics carried over: weight loud BFUs
        err = err * _bias_weights(bias, sf_idx.device)[sf_idx.long()].unsqueeze(-1)
    return err


def rdo_priorities(
    bfu_data: torch.Tensor, sf_idx: torch.Tensor, allocation_bias: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(priority f32 [F, 52, 15], valid bool [F, 52, 15]) of every step.

    A step is priced by its measured squared-error reduction per bit; the
    upper concave hull per BFU (a backward running max) makes the prices
    non-increasing in word length.  A step is valid where its BFU's scale
    factor is nonzero and its price is > 0 (not NaN): per BFU the valid
    steps are one run of consecutive word lengths, after the last NaN."""
    t = _tables(sf_idx.device)
    err = rdo_errors(bfu_data, sf_idx, allocation_bias)
    slopes = (err[..., :-1] - err[..., 1:]) * t["per_bit"]                       # [F, 52, 15]
    prio = _running_max_from_right(slopes)
    return prio, (sf_idx > 0).unsqueeze(-1) & (prio > 0)


def reference_candidates(sf_idx: torch.Tensor, allocation_bias: float) -> torch.Tensor:
    """The reference allocator's candidates in sweep order: int32 [F, 780].

    One int32 key per candidate, rank 10 bits | bfu 6 | cost 12 | valid 1:
    an ascending sort reproduces the spec's stable descending-priority
    order, because equal priorities share a rank and the payload bits break
    the tie in (bfu, word length) order.  Keys are unique or the sentinel,
    so the sort need not be stable."""
    t = _tables(sf_idx.device)
    ranks = _rank_table(float(allocation_bias), sf_idx.device)[sf_idx.long()]          # [F, 52, 15]
    key = (ranks.reshape(-1, _NCAND) << 19) | t["payload"] | 1
    valid = (sf_idx > 0).repeat_interleave(15, dim=1)
    key = torch.where(valid, key, _INVALID_KEY)
    return torch.sort(key, dim=-1).values & 0x7FFFF


def allocate_bits(sf_idx: torch.Tensor, allocation_bias: float, plain: bool = False) -> torch.Tensor:
    """The reference allocator.  sf_idx: int32 [F, 52] scale factor indices.

    Returns word_lengths int32 [F, 52] honoring used + 40 + 10 * 52 <= 1696."""
    if plain:
        return bitalloc_kernels.alloc_sweep_plain(reference_candidates(sf_idx, allocation_bias))
    return bitalloc_kernels.alloc_reference(sf_idx.contiguous(), allocation_bias)


def rdo_candidates(bfu_data: torch.Tensor, sf_idx: torch.Tensor, allocation_bias: float) -> torch.Tensor:
    """The measured-distortion allocator's candidates in sweep order: int32 [F, 780].

    The steps of `rdo_priorities`, ordered by one stable sort.  bfu_data:
    f32 [F, 52, 20]; sf_idx: int32 [F, 52]."""
    t = _tables(sf_idx.device)
    prio, valid = rdo_priorities(bfu_data, sf_idx, allocation_bias)
    prio, valid = prio.reshape(-1, _NCAND), valid.reshape(-1, _NCAND)
    # non-negative f32 bit patterns sort like the floats; negated, one
    # ascending stable sort gives the descending sweep (ties keep candidate
    # order: lower word lengths first within a BFU)
    key = torch.where(valid, -prio.clamp(min=0.0).view(torch.int32), 2**31 - 1)
    payload = t["payload"] | valid.to(torch.int32)
    order = torch.sort(key, dim=-1, stable=True).indices
    return payload.gather(1, order)


def allocate_bits_rdo(
    bfu_data: torch.Tensor, sf_idx: torch.Tensor, allocation_bias: float, plain: bool = False
) -> torch.Tensor:
    """Measured-distortion greedy RDO, the default allocator (at least the
    reference heap's round-trip PSNR; `carta1_tpu/ops/bitalloc.py`).

    bfu_data: f32 [F, 52, 20]; sf_idx: int32 [F, 52].
    Returns word_lengths int32 [F, 52] honoring used + 40 + 10 * 52 <= 1696."""
    if plain:
        return bitalloc_kernels.alloc_sweep_plain(rdo_candidates(bfu_data, sf_idx, allocation_bias))
    return bitalloc_kernels.alloc_rdo(bfu_data.contiguous(), sf_idx.contiguous(), allocation_bias)
