"""K6: the reference's forward transforms on its FFT, CUDA kernel wrappers.

Replaces `carta1_tpu/gold/transforms.py` `mdct_js` (:42) and
`carta1_tpu/gold/fftjs.py` `magnitude_spectrum_js` (:94), both built on
`fft_js` (:57): the exact encoder's forward MDCT (sizes 64, 256, 512) and
the transient detector's FFT magnitude (sizes 128, 256).  The JAX package
computes them in NumPy on the host.  In plain PyTorch each radix-2 stage
with its f32 store is about 12 launches, some 50 stages per chunk; the
kernel (`csrc/fft_js.cu`) runs a whole transform per launch, with the same
f64 operations and f32 stores (see the source).  `mdct_js_masked`
transforms only the rows a mask selects and writes zeros elsewhere: the
encoder keeps a frame's short MDCT only where its band's mode is short.

The plain versions are `gold/transforms.mdct_js_plain`,
`gold/transforms.mdct_js_masked_plain` and
`gold/fftjs.magnitude_spectrum_js_plain`; the wrappers run them for a CPU
tensor and launch the kernel for a CUDA tensor, raising on error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.gold.fftjs import magnitude_spectrum_js_plain
from carta1_tpu_torch.gold.transforms import mdct_js_masked_plain, mdct_js_plain
from carta1_tpu_torch.tables import fft_tables, mdct_tables

MDCT_SIZES = (64, 256, 512)
SPECTRUM_SIZES = (128, 256)
# rows one block of csrc/fft_js.cu takes: one warp of rows at MDCT size 64,
# else 128 threads with N/8 per transform (N the FFT's points)
ROWS = {("mdct", 64): 32} | {(kind, size): 128 // (n // 8) for kind, size, n in
                             (("mdct", 256, 64), ("mdct", 512, 128), ("spectrum", 128, 128), ("spectrum", 256, 256))}


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("fft_js")
    fn = lib.carta1_fftjs
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _host_tables(kind: str, size: int, scale: float | None = None):
    """(sincos, tw_re, tw_im) f64 in host memory; sincos is empty for the
    spectrum, and the MDCT's is at `scale` (by default the reference
    encoder's).  Cached: the arrays outlive the calls that read them."""
    if kind == "mdct":
        sincos, _, tw_re, tw_im = mdct_tables(size, scale)
    else:
        _, tw_re, tw_im = fft_tables(size)
        sincos = tw_re[:0]
    return sincos, tw_re, tw_im


@functools.lru_cache(maxsize=None)
def _tables(kind: str, size: int, scale: float | None, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The same tables on `device`."""
    return tuple(torch.from_numpy(a.copy()).to(device) for a in _host_tables(kind, size, scale))


def _launch(x: torch.Tensor, out: torch.Tensor, kind: str, size: int, active: torch.Tensor | None = None,
            scale: float | None = None):
    if x.shape[0] == 0:
        return out
    if x.data_ptr() % 16:                                  # rows are copied in 16-byte pieces
        x = x.clone()
    host = _host_tables(kind, size, scale)
    sincos, tw_re, tw_im = _tables(kind, size, scale, x.device)
    lib, fn = _kernel()
    mode, n = (0, size >> 2) if kind == "mdct" else (1, size)
    mask = kernels.ptr(active) if active is not None else None
    err = kernels.launch(fn, x.device, kernels.ptr(x), kernels.ptr(out), mask, kernels.ptr(sincos),
                         kernels.ptr(tw_re), kernels.ptr(tw_im), *(a.ctypes.data for a in host), x.shape[0], mode, n)
    name = f"fft_js_{kind}_{size}"
    kernels.check(lib, err, name)
    kernels.count(name)
    return out


def _check_mdct(x: torch.Tensor, size: int) -> None:
    if size not in MDCT_SIZES:
        raise ValueError(f"mdct size must be one of {MDCT_SIZES}, got {size}")
    kernels.require(x, "fft_js_mdct", torch.float32, 2)
    if x.shape[1] != size:
        raise ValueError(f"fft_js_mdct: need [B, {size}] samples, got {tuple(x.shape)}")


def mdct_js(x: torch.Tensor, size: int, scale: float | None = None) -> torch.Tensor:
    """Forward MDCT: f32 [B, size] -> f32 [B, size/2], at the reference
    encoder's scale or at `scale` (a sincos table, the same kernel)."""
    _check_mdct(x, size)
    if x.device.type == "cpu":
        return mdct_js_plain(x, size, scale)
    out = torch.empty((x.shape[0], size >> 1), dtype=torch.float32, device=x.device)
    return _launch(x, out, "mdct", size, scale=scale)


def mdct_js_masked(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The MDCT of size 64 of the rows whose `active` flag is set, zeros
    elsewhere: f32 [B, 64], bool [B] -> f32 [B, 32].  The kernel reads the
    mask on the card and skips the inactive rows' arithmetic and reads."""
    _check_mdct(x, 64)
    kernels.require(active, "fft_js_mdct_masked", torch.bool, 1)
    if active.shape[0] != x.shape[0] or active.device != x.device:
        raise ValueError(f"fft_js_mdct_masked: need a bool [{x.shape[0]}] mask on {x.device}, got "
                         f"{tuple(active.shape)} on {active.device}")
    if x.device.type == "cpu":
        return mdct_js_masked_plain(x, active)
    return _launch(x, torch.empty((x.shape[0], 32), dtype=torch.float32, device=x.device), "mdct", 64, active)


def magnitude_spectrum_js(x: torch.Tensor, fft_size: int) -> torch.Tensor:
    """FFT magnitude of f32 [B, L] samples zero padded or cut to fft_size:
    f32 [B, fft_size/2]."""
    if fft_size not in SPECTRUM_SIZES:
        raise ValueError(f"spectrum size must be one of {SPECTRUM_SIZES}, got {fft_size}")
    kernels.require(x, "fft_js_spectrum", torch.float32, 2)
    if x.device.type == "cpu":
        return magnitude_spectrum_js_plain(x, fft_size)
    if x.shape[1] != fft_size:                                   # the plain version's zero padding or cut
        x = torch.nn.functional.pad(x[:, :fft_size], (0, max(0, fft_size - x.shape[1]))).contiguous()
    out = torch.empty((x.shape[0], fft_size >> 1), dtype=torch.float32, device=x.device)
    return _launch(x, out, "spectrum", fft_size)
