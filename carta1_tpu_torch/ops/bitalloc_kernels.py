"""K4: the allocators' budgeted greedy sweep, CUDA kernel and plain PyTorch version.

Replaces `carta1_tpu/ops/bitalloc.py` `_sweep`: a `lax.scan` over the 780
candidate positions that XLA compiles into one program.  The JAX package
has no Pallas kernel here; the port needs a kernel all the same, because
the loop written as eager PyTorch is about twelve [F]-wide launches per
position.  The CUDA kernel (`csrc/alloc_sweep.cu`) gives one thread per
frame, which walks its candidates in order with the abandoned set in a
register and the counters in shared memory; tiles of candidates are staged
through shared memory by the block's other warps, one tile ahead, so the
reads of [F, 780] stay coalesced and overlap the walk.

Bound on the H100: bytes -- one int32 read per candidate and 52 written
per frame, against a few integer operations each.

Both versions take the candidates of each frame in sweep order as int32
[F, M], each packed `bfu << 13 | cost << 1 | valid`, and return the word
lengths int32 [F, 52]: per frame `remaining = budget`; a candidate that is
not valid or whose BFU is abandoned is skipped; one that costs more than
`remaining` abandons its BFU; any other is paid for and adds one to its
BFU's word length (`gold/coding.py` `allocate_bits_sweep`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.constants import NUM_BFUS
from carta1_tpu_torch.tables import RDO_BUDGET

# the tiling of csrc/alloc_sweep.cu: frames per block
BLOCK_FRAMES = 64
_BFU_SLOTS = 64              # the 6-bit BFU field


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("alloc_sweep")
    fn = lib.carta1_alloc_sweep
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(cands: torch.Tensor) -> None:
    kernels.require(cands, "alloc_sweep", torch.int32, 2)
    if cands.shape[1] == 0:
        raise ValueError(f"alloc_sweep: need int32 [F, M] candidates with M > 0, got {tuple(cands.shape)}")


def alloc_sweep_plain(cands: torch.Tensor, budget: int = RDO_BUDGET) -> torch.Tensor:
    """Plain PyTorch version: the same loop as [F]-wide ops over the M positions."""
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


def alloc_sweep(cands: torch.Tensor, budget: int = RDO_BUDGET) -> torch.Tensor:
    """Kernel wrapper: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (launched on the current stream, raising on error)."""
    _check(cands)
    if cands.device.type == "cpu":
        return alloc_sweep_plain(cands, budget)
    out = torch.empty((cands.shape[0], NUM_BFUS), dtype=torch.int32, device=cands.device)
    if cands.shape[0] == 0:
        return out
    lib, fn = _kernel()
    err = fn(
        kernels.ptr(cands), kernels.ptr(out), cands.shape[0], cands.shape[1], budget,
        kernels.stream_handle(cands),
    )
    kernels.check(lib, err, "alloc_sweep")
    kernels.count("alloc_sweep")
    return out
