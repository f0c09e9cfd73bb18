"""K1: the bit-exact IMDCT core, CUDA kernel and plain PyTorch version.

Replaces `carta1_tpu/ops/exact_fft_pallas.py` `_imdct_core_call` (body
`_core_body`, wrapper `imdct_exact_pallas`), reached from
`carta1_tpu/ops/exact_decode.py` `imdct_exact`.  The TPU kernel emulates
f64 with f32 error-free expansions; the CUDA kernel (`csrc/imdct_exact.cu`)
computes in IEEE f64 with one rounding per operation, mirroring the gold
engine's `imdct_js` + `fft_js` store for store.

Bound on the H100: bytes at sizes 256 and 512 (8 bytes of device traffic
per coefficient against 21-24 f64 operations), the launch itself at size
64.  Rows enter and leave shared memory as coalesced 16-byte copies; at
size 64 one thread holds a whole 16-point transform in registers; at 256
and 512 a thread holds 8 points and runs three radix-2 stages per pass, a
transform's threads share a warp, and `__syncwarp` is the only barrier
between stages.  Twiddles are kernel parameters or shared-memory copies.
Only the middle half of the output is computed, the only part the decoder
reads.  `TILE` is the rows one block takes, per size.

Both versions take f32 [B, size/2] spectra and return f32 [B, size/2]: the
middle half [size/4, 3size/4) of the size-sample inverse transform.  The
transform's scale (mdct.js:20-38) is its sincos table: by default the
reference decoder's (`tables.IMDCT_SCALES`), any other through `scale`,
with the same kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.tables import imdct_tables

SIZES = (64, 256, 512)
TILE = {64: 32, 256: 32, 512: 16}   # rows per block in csrc/imdct_exact.cu


@functools.lru_cache(maxsize=None)
def _tables(size: int, scale: float | None, device: torch.device) -> tuple[torch.Tensor, ...]:
    sincos, perm, tw_re, tw_im = imdct_tables(size, scale)
    return tuple(
        torch.from_numpy(a.copy()).to(device)
        for a in (sincos, perm, tw_re, tw_im)
    )


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("imdct_exact")
    fn = lib.carta1_imdct_mid
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, size: int) -> None:
    if size not in SIZES:
        raise ValueError(f"imdct size must be one of {SIZES}, got {size}")
    kernels.require(x, "imdct_mid", torch.float32, 2, align=16)
    if x.shape[1] != size >> 1:
        raise ValueError(f"imdct_mid: need [B, {size >> 1}] spectra, got {tuple(x.shape)}")


def imdct_mid_plain(x: torch.Tensor, size: int, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: the gold f64 arithmetic as separate
    elementwise ops on any device (each op is one rounding, as in gold)."""
    _check(x, size)
    sincos, perm, tw_re, tw_im = _tables(size, scale, x.device)
    perm = perm.long()
    half, n = size >> 1, size >> 2
    b = x.shape[0]
    xd = x.double()

    # pre-twiddle, bit-reversed order (mdct.js:149-157)
    r = -xd[:, 2 * perm]
    s_ = -xd[:, half - 1 - 2 * perm]
    c, s = sincos[2 * perm], sincos[2 * perm + 1]
    re = (s_ * s + r * c).float()
    im = (s_ * c - r * s).float()

    # radix-2 DIT stages, f32 store per butterfly (fft.js:42-65)
    off, stride = 0, 2
    while stride <= n:
        h = stride >> 1
        rv = re.view(b, n // stride, stride).double()
        iv = im.view(b, n // stride, stride).double()
        er, orr = rv[..., :h], rv[..., h:]
        ei, oi = iv[..., :h], iv[..., h:]
        tr, ti = tw_re[off:off + h], tw_im[off:off + h]
        t_r = orr * tr - oi * ti
        t_i = orr * ti + oi * tr
        re = torch.cat([er + t_r, er - t_r], dim=-1).float().reshape(b, n)
        im = torch.cat([ei + t_i, ei - t_i], dim=-1).float().reshape(b, n)
        off += h
        stride <<= 1

    # post-twiddle (mdct.js:168-205); middle half: i1[i] at 2i, r1[i] at half-1-2i
    rv, iv = re.double(), im.double()
    c, s = sincos[0::2], sincos[1::2]
    r1 = (rv * c + iv * s).float()
    i1 = (rv * s - iv * c).float()
    out = torch.empty((b, half), dtype=torch.float32, device=x.device)
    out[:, 0::2] = i1
    out[:, 1::2] = r1.flip(-1)
    return out


def imdct_mid(x: torch.Tensor, size: int, scale: float | None = None) -> torch.Tensor:
    """Kernel wrapper: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (launched on the current stream, raising on error)."""
    _check(x, size)
    if x.device.type == "cpu":
        return imdct_mid_plain(x, size, scale)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    sincos, _, tw_re, tw_im = _tables(size, scale, x.device)
    host = imdct_tables(size, scale)    # cached: the arrays outlive the call that reads them
    lib, fn = _kernel()
    err = kernels.launch(
        fn, x.device,
        kernels.ptr(x), kernels.ptr(out), kernels.ptr(sincos), kernels.ptr(tw_re), kernels.ptr(tw_im),
        host[0].ctypes.data, host[2].ctypes.data, host[3].ctypes.data,
        x.shape[0], size,
    )
    kernels.check(lib, err, f"imdct_exact_{size}")
    kernels.count(f"imdct_exact_{size}")
    return out
