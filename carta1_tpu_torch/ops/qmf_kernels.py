"""K2: the bit-exact QMF synthesis taps, CUDA kernel and plain PyTorch version.

Replaces `carta1_tpu/ops/exact_qmf_pallas.py` `_qmf_core_call` (body
`_tap_body`, wrapper `qmf_taps_pallas`), reached from
`carta1_tpu/ops/exact_decode.py` `qmf_synthesis_exact`.  The TPU kernel
carries the f64 sums as f32 error-free expansions; the CUDA kernel
(`csrc/qmf_taps.cu`) runs the gold loop (`gold/transforms.py`
`qmf_synthesis_stream`): an IEEE f64 sum over the 24 taps in tap order,
rounded once to f32.

Bound on the H100: operations -- 96 f64 multiplies and adds per output
pair that may not fuse (half the FMA rate), beside 16-17 bytes of device
traffic; f32 -> f64 widenings run at a quarter of the add rate.  A block
stages its rows' samples in shared memory once (8-byte `cp.async`); a
thread computes `PAIRS` consecutive output pairs, widening each sample of
its window once and feeding it to every output that uses it, the taps of
each output still in order j = 0..23; the taps are kernel parameters.
`tile_rows(s)` is the rows one block takes.

Both versions take the halo-prefixed work stream f32 [B, 46 + 2s] and
return f32 [B, 2s] with out[2i] = s1[i], out[2i+1] = s0[i].
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.constants import QMF_DELAY, QMF_EVEN, QMF_ODD

_NTAPS = 24
_TAPS = np.concatenate([QMF_EVEN, QMF_ODD]).astype(np.float64)   # exact f32 -> f64; read by each launch

# the tiling of csrc/qmf_taps.cu
THREADS = 128
PAIRS = 8


def tile_rows(s: int) -> int:
    """Rows of [B, 46 + 2s] work that one block of the kernel takes."""
    return THREADS // min(-(-s // PAIRS), 256 // PAIRS)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("qmf_taps")
    fn = lib.carta1_qmf_taps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(work: torch.Tensor) -> int:
    kernels.require(work, "qmf_taps", torch.float32, 2, align=8)
    w = work.shape[1]
    if w < QMF_DELAY + 2 or (w - QMF_DELAY) % 2:
        raise ValueError(f"qmf_taps: need [B, 46 + 2s] work, got {tuple(work.shape)}")
    return (w - QMF_DELAY) // 2


def qmf_taps_plain(work: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the gold tap loop as separate f64 ops."""
    s = _check(work)
    wv = work.double()
    s0 = torch.zeros((work.shape[0], s), dtype=torch.float64, device=work.device)
    s1 = torch.zeros_like(s0)
    for j in range(_NTAPS):
        s0 = s0 + wv[:, 2 * j:2 * j + 2 * s:2] * float(QMF_EVEN[j])
        s1 = s1 + wv[:, 2 * j + 1:2 * j + 2 * s + 1:2] * float(QMF_ODD[j])
    out = torch.empty((work.shape[0], 2 * s), dtype=torch.float32, device=work.device)
    out[:, 0::2] = s1.float()
    out[:, 1::2] = s0.float()
    return out


def qmf_taps(work: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (launched on the current stream, raising on error)."""
    s = _check(work)
    if work.device.type == "cpu":
        return qmf_taps_plain(work)
    out = torch.empty((work.shape[0], 2 * s), dtype=torch.float32, device=work.device)
    if work.shape[0] == 0 or s == 0:
        return out
    lib, fn = _kernel()
    err = kernels.launch(
        fn, work.device, kernels.ptr(work), kernels.ptr(out), _TAPS.ctypes.data, work.shape[0], s,
    )
    kernels.check(lib, err, "qmf_taps")
    kernels.count("qmf_taps")
    return out
