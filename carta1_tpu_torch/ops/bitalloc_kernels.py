"""K4: the whole bit allocator as one CUDA kernel, and its plain PyTorch version.

Replaces `carta1_tpu/ops/bitalloc.py` `allocate_bits_rdo` (:102) and
`allocate_bits` (:187), each of which XLA compiles into one program around a
`lax.sort` and the `lax.scan` of `_sweep`.  The JAX package has no Pallas
kernel here.  As eager PyTorch the measured-distortion allocator is about
300 launches per chunk (16 quantize passes over [F, 52, 20], the hull, a
stable sort of [F, 780] keys) and the sweep a few thousand more, so on the
card each allocator is one launch of `csrc/alloc_sweep.cu`: it reads the
coefficients and scale factors and writes the word lengths; the error
curves, the slopes and the sorted candidates never reach device memory.

The kernel needs no sort.  After the hull a BFU's step prices are
non-increasing in word length, so the stable descending sort of all 780
steps followed by the sweep equals a 52-way merge of the per-BFU lists
with ties to the lower BFU, which is the reference's own max-heap; a BFU
that is abandoned, or whose next step is not valid, leaves the merge.  The
reference allocator has the same structure, with the rank table's
priorities, which are strictly decreasing along a BFU's steps; its kernel
first bisects for the prefix of the sweep that is all paid for
(`reference_tables`: the steps of each scale factor below each rank) and
merges only the rest, with one packed key per BFU
(`testing.bisect_sweep_reference` is its NumPy model).

Plain version: the candidates in sweep order (`bitalloc.rdo_candidates` or
`reference_candidates`: one `torch.sort`) and the sweep
(`alloc_sweep_plain`: per frame `remaining = budget`; a candidate that is
not valid or whose BFU is abandoned is skipped; one that costs more than
`remaining` abandons its BFU; any other is paid for and adds one to its
BFU's word length, `gold/coding.py` `allocate_bits_sweep`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.constants import MAX_BFU_SIZE, NUM_BFUS, SPECS_PER_BFU, WORD_LENGTH_BITS
from carta1_tpu_torch.tables import RDO_BUDGET, RDO_CAND_COST

# the tiling of csrc/alloc_sweep.cu: frames (one warp each) per block
BLOCK_FRAMES = 4
_BFU_SLOTS = 64              # the 6-bit BFU field


def _bitalloc():
    # ops.bitalloc imports this module; its candidate functions and tables are
    # the other half of the plain version
    from carta1_tpu_torch.ops import bitalloc

    return bitalloc


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = kernels.library("alloc_sweep")
    rdo, ref = lib.carta1_alloc_rdo, lib.carta1_alloc_reference
    rdo.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    ref.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rdo.restype = ref.restype = ctypes.c_int
    return lib, rdo, ref


@functools.lru_cache(maxsize=None)
def _step_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cost int32 [52, 15] of each step, SPECS_PER_BFU int32 [52])."""
    cost = torch.from_numpy(np.ascontiguousarray(RDO_CAND_COST.reshape(NUM_BFUS, 15))).to(device)
    return cost, torch.from_numpy(SPECS_PER_BFU.astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _rdo_tables(bias: float, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(norm, step f32 [64, 16], weight f32 [64], per_bit f32 [52, 15]) for
    the kernel, made on the card by the plain version's own ops."""
    ba = _bitalloc()
    t = ba._tables(device)
    sf_all = torch.arange(64, device=device)
    norm, step = ba.quant_factors(t["sf32"], sf_all > 0)
    # the plain version weighs the errors only for bias != 1; x * 1.0 == x
    weight = ba._bias_weights(bias, device) if bias != 1.0 else torch.ones(64, device=device)
    return norm.contiguous(), step.contiguous(), weight, t["per_bit"]


@functools.lru_cache(maxsize=None)
def reference_tables(bias: float) -> dict[str, np.ndarray]:
    """What the reference allocator's kernel reads, made on the host:

    - rank int32 [64, 15]: `bitalloc._rank_table`, the sweep's order;
    - count uint8 [levels + 1, 64]: count[r, s] = the steps of a BFU at
      scale factor index s whose rank is below r (row 0, no candidate, all
      zero), levels = the largest rank + 1;
    - specs int32 [52], bits int32 [16]: a BFU's first n steps cost
      specs[b] * bits[n] (`RDO_CAND_COST`, cumulated).

    The kernel's key packs 1023 - rank in 10 bits and a step's cost in 6."""
    rank = _bitalloc()._rank_table(float(bias), torch.device("cpu")).numpy()
    levels = int(rank.max()) + 1
    bits = WORD_LENGTH_BITS.astype(np.int32)
    cost = SPECS_PER_BFU[:, None] * np.diff(bits)[None, :]
    if levels > 1024 or not np.array_equal(cost.reshape(-1), RDO_CAND_COST) or RDO_CAND_COST.max() >= 64:
        raise ValueError("alloc_reference: ranks or step costs outside the kernel's key")
    count = (rank[None, :, :] < np.arange(levels + 1)[:, None, None]).sum(axis=-1).astype(np.uint8)
    count[:, 0] = 0
    return {"rank": rank, "count": np.ascontiguousarray(count), "specs": SPECS_PER_BFU.astype(np.int32), "bits": bits}


@functools.lru_cache(maxsize=None)
def _reference_tables(bias: float, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in reference_tables(bias).items()}


def _check_sf(sf_idx: torch.Tensor, name: str) -> None:
    kernels.require(sf_idx, name, torch.int32, 2)
    if sf_idx.shape[1] != NUM_BFUS:
        raise ValueError(f"{name}: need int32 [F, {NUM_BFUS}] scale factor indices, got {tuple(sf_idx.shape)}")


def _check_rdo(bfu_data: torch.Tensor, sf_idx: torch.Tensor) -> None:
    _check_sf(sf_idx, "alloc_rdo")
    kernels.require(bfu_data, "alloc_rdo", torch.float32, 3, align=16)
    if tuple(bfu_data.shape) != (sf_idx.shape[0], NUM_BFUS, MAX_BFU_SIZE) or bfu_data.device != sf_idx.device:
        raise ValueError(
            f"alloc_rdo: need f32 [F, {NUM_BFUS}, {MAX_BFU_SIZE}] coefficients beside int32 [F, {NUM_BFUS}] "
            f"scale factors on one device, got {tuple(bfu_data.shape)} on {bfu_data.device} and "
            f"{tuple(sf_idx.shape)} on {sf_idx.device}"
        )


def _check(cands: torch.Tensor) -> None:
    kernels.require(cands, "alloc_sweep", torch.int32, 2)
    if cands.shape[1] == 0:
        raise ValueError(f"alloc_sweep: need int32 [F, M] candidates with M > 0, got {tuple(cands.shape)}")


def alloc_sweep_plain(cands: torch.Tensor, budget: int = RDO_BUDGET) -> torch.Tensor:
    """The sweep over candidates in sweep order, int32 [F, M] packed
    `bfu << 13 | cost << 1 | valid`, as [F]-wide ops over the M positions:
    int32 [F, 52] word lengths."""
    _check(cands)
    nframes = cands.shape[0]
    dev = cands.device
    remaining = torch.full((nframes,), budget, dtype=torch.int32, device=dev)
    abandoned = torch.zeros((nframes, _BFU_SLOTS), dtype=torch.bool, device=dev)
    word_lengths = torch.zeros((nframes, _BFU_SLOTS), dtype=torch.int32, device=dev)
    for c in cands.unbind(dim=1):
        bfu = ((c >> 13) & (_BFU_SLOTS - 1)).long().unsqueeze(1)            # [F, 1]
        cost = (c >> 1) & 0xFFF
        was_abandoned = abandoned.gather(1, bfu).squeeze(1)
        can = ((c & 1) == 1) & ~was_abandoned
        fits = can & (cost <= remaining)
        remaining = remaining - torch.where(fits, cost, 0)
        abandoned.scatter_(1, bfu, (was_abandoned | (can & ~fits)).unsqueeze(1))
        word_lengths.scatter_add_(1, bfu, fits.to(torch.int32).unsqueeze(1))
    return word_lengths[:, :NUM_BFUS].contiguous()


def alloc_rdo_plain(bfu_data: torch.Tensor, sf_idx: torch.Tensor, allocation_bias: float,
                    budget: int = RDO_BUDGET) -> torch.Tensor:
    """Plain version of `alloc_rdo`: sorted candidates, then the sweep."""
    _check_rdo(bfu_data, sf_idx)
    return alloc_sweep_plain(_bitalloc().rdo_candidates(bfu_data, sf_idx, allocation_bias), budget)


def alloc_reference_plain(sf_idx: torch.Tensor, allocation_bias: float, budget: int = RDO_BUDGET) -> torch.Tensor:
    """Plain version of `alloc_reference`: sorted candidates, then the sweep."""
    _check_sf(sf_idx, "alloc_reference")
    return alloc_sweep_plain(_bitalloc().reference_candidates(sf_idx, allocation_bias), budget)


def alloc_rdo(bfu_data: torch.Tensor, sf_idx: torch.Tensor, allocation_bias: float,
              budget: int = RDO_BUDGET) -> torch.Tensor:
    """The measured-distortion allocator: f32 [F, 52, 20] coefficients and
    int32 [F, 52] scale factor indices (0..63) -> int32 [F, 52] word
    lengths.  Kernel wrapper: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (launched on the current stream, raising on
    error)."""
    _check_rdo(bfu_data, sf_idx)
    if sf_idx.device.type == "cpu":
        return alloc_rdo_plain(bfu_data, sf_idx, allocation_bias, budget)
    out = torch.empty((sf_idx.shape[0], NUM_BFUS), dtype=torch.int32, device=sf_idx.device)
    if sf_idx.shape[0] == 0:
        return out
    norm, step, weight, per_bit = _rdo_tables(float(allocation_bias), sf_idx.device)
    cost, specs = _step_tables(sf_idx.device)
    lib, fn, _ = _kernels()
    err = kernels.launch(
        fn, sf_idx.device,
        kernels.ptr(bfu_data), kernels.ptr(sf_idx), kernels.ptr(norm), kernels.ptr(step), kernels.ptr(weight),
        kernels.ptr(per_bit), kernels.ptr(cost), kernels.ptr(specs), kernels.ptr(out), sf_idx.shape[0], budget,
    )
    kernels.check(lib, err, "alloc_rdo")
    kernels.count("alloc_rdo")
    return out


def alloc_reference(sf_idx: torch.Tensor, allocation_bias: float, budget: int = RDO_BUDGET) -> torch.Tensor:
    """The reference allocator: int32 [F, 52] scale factor indices (0..63)
    -> int32 [F, 52] word lengths.  Kernel wrapper: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    _check_sf(sf_idx, "alloc_reference")
    if sf_idx.device.type == "cpu":
        return alloc_reference_plain(sf_idx, allocation_bias, budget)
    out = torch.empty((sf_idx.shape[0], NUM_BFUS), dtype=torch.int32, device=sf_idx.device)
    if sf_idx.shape[0] == 0:
        return out
    t = _reference_tables(float(allocation_bias), sf_idx.device)
    lib, _, fn = _kernels()
    err = kernels.launch(fn, sf_idx.device, *(kernels.ptr(x) for x in (sf_idx, t["count"], t["rank"], t["specs"],
                                                                      t["bits"], out)),
                         sf_idx.shape[0], budget, t["count"].shape[0] - 1)
    kernels.check(lib, err, "alloc_reference")
    kernels.count("alloc_reference")
    return out
