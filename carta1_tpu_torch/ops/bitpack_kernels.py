"""K3, the sound-unit field read (CUDA kernel and plain PyTorch version),
and K7, the sound-unit pack (its plain version is `ops/bitpack.pack_frames_plain`).

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

K7 (`csrc/bitpack_write.cu`, `pack_units`) writes the 212-byte units from
the five FrameData fields in one launch; it replaces no Pallas kernel (the
JAX package's device pack is XLA).  Bound on the H100: bytes -- a frame
reads at most 4,592 bytes of fields and writes 212.  One warp per frame.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.constants import FRAME_BITS, MAX_BFU_SIZE, NUM_BFUS, SOUND_UNIT_SIZE

N_ANCHORS = 128
BLOCK_FRAMES = 8            # K7's frames (warps) per block: kWarps of csrc/bitpack_write.cu
# each field's shape past the frame axis, in K7's argument order
PACK_FIELDS = (("n_bfu", ()), ("block_modes", (3,)), ("scale_factors", (NUM_BFUS,)),
               ("word_lengths", (NUM_BFUS,)), ("quantized", (NUM_BFUS, MAX_BFU_SIZE)))


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


@functools.lru_cache(maxsize=None)
def _pack_kernel():
    lib = kernels.library("bitpack_write")
    fn = lib.carta1_pack_units
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def pack_units(
    n_bfu: torch.Tensor, block_modes: torch.Tensor, scale_factors: torch.Tensor,
    word_lengths: torch.Tensor, quantized: torch.Tensor,
) -> torch.Tensor:
    """K7: FrameData fields int32 [N], [N, 3], [N, 52], [N, 52], [N, 52, 20],
    contiguous on one card (quantized 16-byte aligned) -> uint8 [N, 212],
    launched on the current stream.  Raises on anything else: CPU tensors
    take `ops/bitpack.pack_frames_plain`."""
    fields = (n_bfu, block_modes, scale_factors, word_lengths, quantized)
    for t, (name, tail) in zip(fields, PACK_FIELDS):
        kernels.require(t, f"pack_units {name}", torch.int32, 1 + len(tail), align=16 if name == "quantized" else 1)
        if t.device.type != "cuda" or t.device != n_bfu.device or tuple(t.shape) != (n_bfu.shape[0], *tail):
            raise ValueError(
                f"pack_units: need the five fields [N], [N, 3], [N, 52], [N, 52], [N, 52, 20] on one card, "
                f"got {name} {tuple(t.shape)} on {t.device} (n_bfu {tuple(n_bfu.shape)} on {n_bfu.device})"
            )
    out = torch.empty((n_bfu.shape[0], SOUND_UNIT_SIZE), dtype=torch.uint8, device=n_bfu.device)
    if out.numel() == 0:
        return out
    lib, fn = _pack_kernel()
    err = kernels.launch(fn, n_bfu.device, *(kernels.ptr(t) for t in fields), kernels.ptr(out), n_bfu.shape[0])
    kernels.check(lib, err, "pack_units")
    kernels.count("pack_units")
    return out
