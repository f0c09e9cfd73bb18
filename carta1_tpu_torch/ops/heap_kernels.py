"""K5: the reference's max-heap bit allocator, CUDA kernel and plain PyTorch version.

Replaces `carta1_tpu/gold/coding.py` `allocate_bits_frame` (:70), called
per frame by `allocate_bits` (:154): the reference's greedy allocation
(bitallocation.js:44-164) as a Python max-heap, with its tie-breaking in
heap-array order and its abandon-on-overflow rule.  The JAX package runs
it on the host (NumPy, one frame at a time); it has no Pallas kernel.

The heap, for one frame:
  * BFUs with a scale factor index > 0 enter in BFU order, each with the
    priority of its step 0 -> 1; then sift_down(i) for i = n/2 - 1 .. 0;
  * sift_down compares the left child first, and only a strictly larger
    priority moves an entry, so ties break in heap-array order;
  * while bits remain: take the root; if its next step costs more than
    what remains, pop it (the last entry to the root, then sift);
    otherwise pay, step its word length, and re-price the root and sift,
    or pop it at the top word length.
Priorities come from `tables.heap_priority_table(bias)`, made on the host
by gold's own NumPy operations, so neither version computes one.

CUDA kernel (`csrc/alloc_heap.cu`): one thread per frame, its heap in
shared memory.  Plain version: the same heap batched over frames, each
root step, pop and sift as masked [F, 52] tensor ops.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.constants import MAX_WORD_LENGTH_INDEX, NUM_BFUS, SPECS_PER_BFU, WORD_LENGTH_BITS
from carta1_tpu_torch.tables import RDO_BUDGET, heap_priority_table

BLOCK_FRAMES = 64            # frames (threads) per block of csrc/alloc_heap.cu
_HEAP_LEVELS = 6             # a heap of 52 entries is 6 levels deep
# the kernel's constants, read from host memory at each launch
_HOST_SPECS = np.ascontiguousarray(SPECS_PER_BFU, dtype=np.int32)
_HOST_BITS = np.ascontiguousarray(WORD_LENGTH_BITS, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("alloc_heap")
    fn = lib.carta1_alloc_heap
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _priorities(bias: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(heap_priority_table(bias).copy()).to(device)      # f64 [64, 15]


@functools.lru_cache(maxsize=None)
def _step_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(WORD_LENGTH_BITS int64 [16], SPECS_PER_BFU int64 [52])."""
    return (torch.from_numpy(WORD_LENGTH_BITS.astype(np.int64)).to(device),
            torch.from_numpy(SPECS_PER_BFU.astype(np.int64)).to(device))


def _check(sf_idx: torch.Tensor) -> None:
    kernels.require(sf_idx, "alloc_heap", torch.int32, 2)
    if sf_idx.shape[1] != NUM_BFUS:
        raise ValueError(f"alloc_heap: need int32 [F, {NUM_BFUS}] scale factor indices, got {tuple(sf_idx.shape)}")


def alloc_heap_plain(sf_idx: torch.Tensor, allocation_bias: float, budget: int = RDO_BUDGET) -> torch.Tensor:
    """Plain version of `alloc_heap`: int32 [F, 52] scale factor indices
    (0..63) -> int32 [F, 52] word lengths, the heap of every frame stepped
    together until none has bits and entries left (one host sync a step)."""
    _check(sf_idx)
    dev = sf_idx.device
    nframes = sf_idx.shape[0]
    pri_tab = _priorities(float(allocation_bias), dev)
    wlb, sizes = _step_tables(dev)
    sf = sf_idx.long()
    rows = torch.arange(nframes, device=dev)

    # entries in BFU order: the valid BFUs moved to the front, stably
    valid = (sf > 0) & (sizes > 0)
    n = torch.count_nonzero(valid, dim=1)
    heap_idx = torch.sort((~valid).to(torch.int32), dim=1, stable=True).indices      # [F, 52]
    heap_pri = pri_tab[sf.gather(1, heap_idx), 0]                                     # [F, 52] f64
    wl = torch.zeros((nframes, NUM_BFUS), dtype=torch.int64, device=dev)

    def sift_down(start: int, active: torch.Tensor) -> None:
        pos = torch.full((nframes,), start, dtype=torch.int64, device=dev)
        iv, pv = heap_idx[:, start].clone(), heap_pri[:, start].clone()
        moving = active
        for _ in range(_HEAP_LEVELS):
            left = 2 * pos + 1
            right = left + 1
            lp = heap_pri[rows, left.clamp(max=NUM_BFUS - 1)]
            rp = heap_pri[rows, right.clamp(max=NUM_BFUS - 1)]
            take_l = (left < n) & (lp > pv)
            mi = torch.where(take_l, left, pos)
            mp = torch.where(take_l, lp, pv)
            mi = torch.where((right < n) & (rp > mp), right, mi)
            moving = moving & (mi != pos)
            heap_idx[rows, pos] = torch.where(moving, heap_idx[rows, mi], heap_idx[rows, pos])
            heap_pri[rows, pos] = torch.where(moving, heap_pri[rows, mi], heap_pri[rows, pos])
            pos = torch.where(moving, mi, pos)
        heap_idx[rows, pos] = torch.where(active, iv, heap_idx[rows, pos])
        heap_pri[rows, pos] = torch.where(active, pv, heap_pri[rows, pos])

    for i in range(NUM_BFUS // 2 - 1, -1, -1):                    # heapify
        sift_down(i, i < n // 2)

    remaining = torch.full((nframes,), budget, dtype=torch.int64, device=dev)
    while True:
        live = (remaining > 0) & (n > 0)
        if not bool(live.any()):
            break
        bfu = heap_idx[:, 0]
        cur = wl[rows, bfu]
        nxt = (cur + 1).clamp(max=MAX_WORD_LENGTH_INDEX)
        cost = (wlb[nxt] - wlb[cur]) * sizes[bfu]
        pays = live & (cost <= remaining) & (cost > 0)
        remaining = torch.where(pays, remaining - cost, remaining)
        wl[rows, bfu] = torch.where(pays, nxt, cur)
        after = (nxt + 1).clamp(max=MAX_WORD_LENGTH_INDEX)
        reprice = pays & (nxt < MAX_WORD_LENGTH_INDEX) & (wlb[after] - wlb[nxt] > 0)
        pop = live & ~reprice
        last = (n - 1).clamp(min=0)
        root_pri = torch.where(reprice, pri_tab[sf[rows, bfu], nxt.clamp(max=MAX_WORD_LENGTH_INDEX - 1)],
                               heap_pri[:, 0])
        heap_pri[:, 0] = torch.where(pop, heap_pri[rows, last], root_pri)
        heap_idx[:, 0] = torch.where(pop, heap_idx[rows, last], bfu)
        n = torch.where(pop, n - 1, n)
        sift_down(0, (reprice | pop) & (n > 0))
    return wl.to(torch.int32)


def alloc_heap(sf_idx: torch.Tensor, allocation_bias: float, budget: int = RDO_BUDGET) -> torch.Tensor:
    """The reference heap allocator: int32 [F, 52] scale factor indices
    (0..63) -> int32 [F, 52] word lengths.  Kernel wrapper: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor (launched
    on the current stream, raising on error)."""
    _check(sf_idx)
    if sf_idx.device.type == "cpu":
        return alloc_heap_plain(sf_idx, allocation_bias, budget)
    out = torch.empty((sf_idx.shape[0], NUM_BFUS), dtype=torch.int32, device=sf_idx.device)
    if sf_idx.shape[0] == 0:
        return out
    pri_tab = _priorities(float(allocation_bias), sf_idx.device)
    lib, fn = _kernel()
    err = kernels.launch(fn, sf_idx.device, kernels.ptr(sf_idx), kernels.ptr(pri_tab), kernels.ptr(out),
                         _HOST_SPECS.ctypes.data, _HOST_BITS.ctypes.data, sf_idx.shape[0], budget)
    kernels.check(lib, err, "alloc_heap")
    kernels.count("alloc_heap")
    return out
