"""K3: the sound-unit field read, CUDA kernel and plain PyTorch version.

Replaces `carta1_tpu/ops/bitpack_pallas.py` `window_reduce_pallas` (body
`_demux_kernel`), the window read behind `carta1_tpu/ops/bitpack.py`
`_read_fields`.  On the TPU a gather is slow, so the read is a
compare/select reduction over the anchor range; the CUDA kernel
(`csrc/bitpack_read.cu`) is a plain gather, with `_read_fields`' shift,
mask and truncated-field rule (bitstream.js:55) in the same thread.

Bound on the H100: bytes -- each field reads its offset and width and
writes its value (12 bytes) plus its frame's share of the 512-byte window
row; the integer work is a few operations.  One thread per field; a
frame's window row stays in L1 across its fields.

win32 is int32 [F, 128] holding the uint32 window bits
(half[j] << 16) | half[j+1]; offsets and widths are int32 [F, M]; the
result is the unsigned field value as int32 [F, M].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.constants import FRAME_BITS

N_ANCHORS = 128


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("bitpack_read")
    fn = lib.carta1_read_fields
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(win32: torch.Tensor, offsets: torch.Tensor, widths: torch.Tensor) -> None:
    kernels.require(win32, "read_fields win32", torch.int32, 2)
    kernels.require(offsets, "read_fields offsets", torch.int32, 2)
    kernels.require(widths, "read_fields widths", torch.int32, 2)
    if (
        win32.shape[1] != N_ANCHORS
        or offsets.shape != widths.shape
        or offsets.shape[0] != win32.shape[0]
        or not (win32.device == offsets.device == widths.device)
    ):
        raise ValueError(
            f"read_fields: need win32 [F, {N_ANCHORS}] and offsets/widths [F, M] on one "
            f"device, got {tuple(win32.shape)}, {tuple(offsets.shape)}, {tuple(widths.shape)}"
        )


def read_fields_plain(
    win32: torch.Tensor, offsets: torch.Tensor, widths: torch.Tensor, j_lo: int, j_hi: int
) -> torch.Tensor:
    """Plain PyTorch version; the 32-bit windows are held in int64."""
    _check(win32, offsets, widths)
    win = win32.long() & 0xFFFFFFFF
    off = offsets.long()
    h = off >> 4
    inside = (h >= j_lo) & (h < j_hi)
    w = torch.where(inside, torch.gather(win, 1, h.clamp(0, N_ANCHORS - 1)), 0)
    eff = torch.minimum((FRAME_BITS - off).clamp(min=0), widths.long())
    shift = 32 - (off & 15) - eff
    return ((w >> shift) & ((1 << eff) - 1)).int()


def read_fields(
    win32: torch.Tensor, offsets: torch.Tensor, widths: torch.Tensor, j_lo: int, j_hi: int
) -> torch.Tensor:
    """Kernel wrapper: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (launched on the current stream, raising on error)."""
    _check(win32, offsets, widths)
    if offsets.device.type == "cpu":
        return read_fields_plain(win32, offsets, widths, j_lo, j_hi)
    out = torch.empty_like(offsets)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    err = kernels.launch(
        fn, offsets.device,
        kernels.ptr(win32), kernels.ptr(offsets), kernels.ptr(widths), kernels.ptr(out),
        offsets.shape[0], offsets.shape[1], j_lo, j_hi,
    )
    kernels.check(lib, err, "read_fields")
    kernels.count("read_fields")
    return out
