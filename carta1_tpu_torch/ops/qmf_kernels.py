"""K2 and K8: the bit-exact QMF taps, CUDA kernels and plain PyTorch versions.

K2 (`qmf_taps`) is the decoder's synthesis, K8 (`qmf_analysis_taps`) the
exact encoder's analysis; each wrapper runs its plain version for a CPU
tensor and its kernel for a CUDA tensor.

K2 replaces `carta1_tpu/ops/exact_qmf_pallas.py` `_qmf_core_call` (body
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

K8 replaces no Pallas kernel: the JAX package's exact encoder runs the
analysis taps in NumPy (`carta1_tpu/gold/transforms.py`
`qmf_analysis_stream`).  Its plain version is that loop over the 24 taps,
each an f64 multiply and add over the whole stream; the CUDA kernel
(`csrc/qmf_analysis.cu`) sums each output's taps in the same order with K2's
design, reading the stream and its 46-sample delay where they lie.  Both
take signal f32 [B, N] and delay f32 [B, 46] and return (low, high), f32
[B, N // 2] each.
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

# the tiling of csrc/qmf_taps.cu (K2) and csrc/qmf_analysis.cu (K8)
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


def analysis_tile(n: int) -> tuple[int, int]:
    """(rows, output pairs) of [B, n] signal that one block of K8 takes."""
    segs = min(max(-(-(n // 2) // PAIRS), 1), THREADS)
    return THREADS // segs, segs * PAIRS


@functools.lru_cache(maxsize=None)
def _analysis_kernel():
    lib = kernels.library("qmf_analysis")
    fn = lib.carta1_qmf_analysis
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_analysis(signal: torch.Tensor, delay: torch.Tensor) -> int:
    kernels.require(signal, "qmf_analysis_taps", torch.float32, 2)
    kernels.require(delay, "qmf_analysis_taps", torch.float32, 2)
    if delay.shape != (signal.shape[0], QMF_DELAY) or delay.device != signal.device:
        raise ValueError(f"qmf_analysis_taps: need delay [B, {QMF_DELAY}] beside signal [B, N] on its device, got "
                         f"{tuple(delay.shape)} on {delay.device} and {tuple(signal.shape)} on {signal.device}")
    return signal.shape[1] // 2


def qmf_analysis_taps_plain(signal: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the gold tap loop as separate f64 ops over
    work = [delay | signal], even[i] = sum_j work[47 - 2j + 2i] EVEN[j] and
    odd[i] = sum_j work[46 - 2j + 2i] ODD[j] from +0.0 in tap order;
    (f32(even + odd), f32(even - odd))."""
    n_out = _check_analysis(signal, delay)
    work = torch.cat([delay, signal], dim=-1)
    wv = work.double()
    even = torch.zeros((*work.shape[:-1], n_out), dtype=torch.float64, device=work.device)
    odd = torch.zeros_like(even)
    for j in range(_NTAPS):
        e0, o0 = 47 - 2 * j, 46 - 2 * j
        even += wv[..., e0:e0 + 2 * n_out:2] * float(QMF_EVEN[j])
        odd += wv[..., o0:o0 + 2 * n_out:2] * float(QMF_ODD[j])
    return (even + odd).float(), (even - odd).float()


def qmf_analysis_taps(signal: torch.Tensor, delay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: the plain version for a CPU tensor, K8 for a CUDA
    tensor (one launch on the current stream, raising on error; none for
    no rows or N < 2)."""
    n_out = _check_analysis(signal, delay)
    if signal.device.type == "cpu":
        return qmf_analysis_taps_plain(signal, delay)
    low = torch.empty((signal.shape[0], n_out), dtype=torch.float32, device=signal.device)
    high = torch.empty_like(low)
    if signal.shape[0] == 0 or n_out == 0:
        return low, high
    lib, fn = _analysis_kernel()
    err = kernels.launch(
        fn, signal.device, kernels.ptr(signal), kernels.ptr(delay), kernels.ptr(low), kernels.ptr(high),
        _TAPS.ctypes.data, signal.shape[0], signal.shape[1],
    )
    kernels.check(lib, err, "qmf_analysis")
    kernels.count("qmf_analysis")
    return low, high
