"""K6: the reference's forward transforms on its FFT, CUDA kernel wrappers.

Replaces `carta1_tpu/gold/transforms.py` `mdct_js` (:42) and
`carta1_tpu/gold/fftjs.py` `magnitude_spectrum_js` (:94), both built on
`fft_js` (:57): the exact encoder's forward MDCT (sizes 64, 256, 512) and
the transient detector's FFT magnitude (sizes 128, 256).  The JAX package
computes them in NumPy on the host.  In plain PyTorch each radix-2 stage
with its f32 store is about 12 launches, some 50 stages per chunk; the
kernel (`csrc/fft_js.cu`) runs a whole transform per launch, with the same
f64 operations and f32 stores (see the source).

The plain versions are `gold/transforms.mdct_js_plain` and
`gold/fftjs.magnitude_spectrum_js_plain`; the wrappers run them for a CPU
tensor and launch the kernel for a CUDA tensor, raising on error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from carta1_tpu_torch import kernels
from carta1_tpu_torch.gold.fftjs import magnitude_spectrum_js_plain
from carta1_tpu_torch.gold.transforms import mdct_js_plain
from carta1_tpu_torch.tables import fft_tables, mdct_tables

MDCT_SIZES = (64, 256, 512)
SPECTRUM_SIZES = (128, 256)
# rows one block of csrc/fft_js.cu takes: 4096 input floats (MDCT), 2048 (spectrum)
ROWS = {("mdct", s): 4096 // s for s in MDCT_SIZES} | {("spectrum", s): 2048 // s for s in SPECTRUM_SIZES}


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = kernels.library("fft_js")
    fn = lib.carta1_fftjs
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _tables(kind: str, size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sincos, tw_re, tw_im) f64 on `device`; sincos is empty for the spectrum."""
    if kind == "mdct":
        sincos, _, tw_re, tw_im = mdct_tables(size)
    else:
        _, tw_re, tw_im = fft_tables(size)
        sincos = tw_re[:0]
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (sincos, tw_re, tw_im))


def _launch(x: torch.Tensor, out: torch.Tensor, kind: str, size: int) -> torch.Tensor:
    if x.shape[0] == 0:
        return out
    sincos, tw_re, tw_im = _tables(kind, size, x.device)
    lib, fn = _kernel()
    mode, n = (0, size >> 2) if kind == "mdct" else (1, size)
    err = kernels.launch(fn, x.device, kernels.ptr(x), kernels.ptr(out), kernels.ptr(sincos), kernels.ptr(tw_re),
                         kernels.ptr(tw_im), x.shape[0], mode, n)
    name = f"fft_js_{kind}_{size}"
    kernels.check(lib, err, name)
    kernels.count(name)
    return out


def mdct_js(x: torch.Tensor, size: int) -> torch.Tensor:
    """Forward MDCT with the reference's scale: f32 [B, size] -> f32 [B, size/2]."""
    if size not in MDCT_SIZES:
        raise ValueError(f"mdct size must be one of {MDCT_SIZES}, got {size}")
    kernels.require(x, "fft_js_mdct", torch.float32, 2)
    if x.shape[1] != size:
        raise ValueError(f"fft_js_mdct: need [B, {size}] samples, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return mdct_js_plain(x, size)
    return _launch(x, torch.empty((x.shape[0], size >> 1), dtype=torch.float32, device=x.device), "mdct", size)


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
