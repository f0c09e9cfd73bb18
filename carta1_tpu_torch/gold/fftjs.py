"""The reference's radix-2 FFT with its exact rounding, in PyTorch.

The port of `carta1_tpu/gold/fftjs.py`.  The reference (fft.js:14-68) runs
an in-place complex FFT on Float32Arrays: every butterfly result is
computed in f64 and rounded to f32 on store, with twiddles carried in f64
and made by a multiplicative recurrence (`tables.fft_tables`, never
closed-form cos/sin).  The butterflies of one stage are disjoint, so a
stage is a few f64 elementwise ops over every row at once; PyTorch never
fuses a multiply with an add, so each op rounds once, as in the reference.

These are the plain versions of kernel K6 (`ops/fftjs_kernels.py`);
`magnitude_spectrum_js` launches K6 for a tensor on the card.
"""

from __future__ import annotations

import functools

import torch

from carta1_tpu_torch.tables import fft_tables


@functools.lru_cache(maxsize=None)
def _tables(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    perm, tw_re, tw_im = fft_tables(n)
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (perm.astype("int64"), tw_re, tw_im))


def fft_js(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FFT over the last axis of f32 [..., n] (n a power of two):
    bit reversal, then per stage t = o * w in f64 and e +- t stored to f32."""
    n = re.shape[-1]
    if n == 1:
        return re.clone(), im.clone()
    perm, tw_re, tw_im = _tables(n, re.device)
    re, im = re[..., perm], im[..., perm]
    lead = re.shape[:-1]
    off, stride = 0, 2
    while stride <= n:
        h = stride >> 1
        rv = re.reshape(*lead, n // stride, stride).double()
        iv = im.reshape(*lead, n // stride, stride).double()
        er, orr = rv[..., :h], rv[..., h:]
        ei, oi = iv[..., :h], iv[..., h:]
        tr, ti = tw_re[off:off + h], tw_im[off:off + h]
        t_r = orr * tr - oi * ti
        t_i = orr * ti + oi * tr
        re = torch.cat([er + t_r, er - t_r], dim=-1).float().reshape(*lead, n)
        im = torch.cat([ei + t_i, ei - t_i], dim=-1).float().reshape(*lead, n)
        off += h
        stride <<= 1
    return re, im


def magnitude_spectrum_js_plain(samples: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Zero-padded FFT magnitude of the positive frequencies, f32 [..., fft_size/2]
    (performFFT, transient.js:17-35): the real input copied into an f32
    buffer (zero padded or cut to fft_size), `fft_js`, then
    sqrt(re^2 + im^2) in f64 stored to f32."""
    n = min(samples.shape[-1], fft_size)
    re = torch.zeros((*samples.shape[:-1], fft_size), dtype=torch.float32, device=samples.device)
    re[..., :n] = samples[..., :n]
    re, im = fft_js(re, torch.zeros_like(re))
    half = fft_size // 2
    r, i = re[..., :half].double(), im[..., :half].double()
    return torch.sqrt(r * r + i * i).float()


def magnitude_spectrum_js(samples: torch.Tensor, fft_size: int, plain: bool = False) -> torch.Tensor:
    """f32 [..., L] -> [..., fft_size/2]: kernel K6's wrapper (its plain
    version for a CPU tensor), or the plain version with `plain=True`."""
    if plain:
        return magnitude_spectrum_js_plain(samples, fft_size)
    from carta1_tpu_torch.ops import fftjs_kernels   # it imports this module's plain versions

    flat = samples.reshape(-1, samples.shape[-1]).contiguous()
    return fftjs_kernels.magnitude_spectrum_js(flat, fft_size).reshape(*samples.shape[:-1], fft_size // 2)
