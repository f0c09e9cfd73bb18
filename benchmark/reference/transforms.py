"""The reference's transforms, plain PyTorch, batched over leading axes.

Each function repeats the reference JavaScript's arithmetic (codec/
transforms/fft.js, mdct.js, qmf.js): every value is computed in `cdt`,
float64 as JavaScript computes, and rounded to float32 where the
reference stores into a Float32Array.  One PyTorch operation rounds once
and no two are fused, so the roundings fall where the reference's fall.
`cdt=torch.float32` gives the same algorithm one precision lower: the
comparison's control.
"""

from __future__ import annotations

import torch

from benchmark.reference import tables as T

F32 = torch.float32
F64 = torch.float64


def fft_js(re: torch.Tensor, im: torch.Tensor, cdt=F64) -> tuple[torch.Tensor, torch.Tensor]:
    """In-place radix-2 FFT of fft.js:14-68 over the last axis: each
    butterfly computed in `cdt` and stored f32, the twiddles f64 locals."""
    n = re.shape[-1]
    dev = re.device
    perm = T.on("bit_reverse", dev, n)
    re, im = re[..., perm], im[..., perm]
    stride = 2
    while stride <= n:
        half = stride >> 1
        tr, ti = (t.to(cdt) for t in T.on("stage_twiddles", dev, stride))
        shape = (*re.shape[:-1], n // stride, stride)
        rv, iv = re.reshape(shape).to(cdt), im.reshape(shape).to(cdt)
        er, ei, orr, oi = rv[..., :half], iv[..., :half], rv[..., half:], iv[..., half:]
        t_r = orr * tr - oi * ti
        t_i = orr * ti + oi * tr
        re = torch.cat([er + t_r, er - t_r], dim=-1).to(F32).reshape(re.shape)
        im = torch.cat([ei + t_i, ei - t_i], dim=-1).to(F32).reshape(im.shape)
        stride <<= 1
    return re, im


def magnitude_spectrum(samples: torch.Tensor, fft_size: int, cdt=F64) -> torch.Tensor:
    """performFFT (transient.js:17-35): the f32 samples zero padded to
    `fft_size`, the FFT, then sqrt(re^2 + im^2) of the positive bins in
    `cdt`, stored f32."""
    lead, n = samples.shape[:-1], min(samples.shape[-1], fft_size)
    re = torch.zeros((*lead, fft_size), dtype=F32, device=samples.device)
    re[..., :n] = samples[..., :n]
    re, im = fft_js(re, torch.zeros_like(re), cdt)
    r, i = re[..., :fft_size // 2].to(cdt), im[..., :fft_size // 2].to(cdt)
    return torch.sqrt(r * r + i * i).to(F32)


def mdct(x: torch.Tensor, size: int, cdt=F64) -> torch.Tensor:
    """Forward MDCT (mdct.js:54-122) at the codec's scale: [..., size] f32
    -> [..., size/2] f32."""
    half, quarter = size >> 1, size >> 2
    n34 = 3 * quarter
    tbl = T.on("sincos_table", x.device, size, T.MDCT_SCALES[size]).to(cdt)
    xv = x.to(cdt)
    ar = lambda a, b: torch.arange(a, b, 2, device=x.device)  # noqa: E731
    re, im = [], []
    i = ar(0, quarter)                       # first region: i = 0, 2, .. quarter-2
    r = xv[..., n34 - 1 - i] + xv[..., n34 + i]
    s_ = xv[..., quarter + i] - xv[..., quarter - 1 - i]
    c, s = tbl[i], tbl[i + 1]
    re.append(r * c + s_ * s)
    im.append(s_ * c - r * s)
    i = ar(quarter, half)                    # second region: i = quarter, .. half-2
    r = xv[..., n34 - 1 - i] - xv[..., i - quarter]
    s_ = xv[..., quarter + i] + xv[..., 5 * quarter - 1 - i]
    c, s = tbl[i], tbl[i + 1]
    re.append(r * c + s_ * s)
    im.append(s_ * c - r * s)
    re, im = fft_js(torch.cat(re, -1).to(F32), torch.cat(im, -1).to(F32), cdt)
    k = torch.arange(half >> 1, device=x.device)
    c, s = tbl[2 * k], tbl[2 * k + 1]
    rv, iv = re.to(cdt), im.to(cdt)
    even = (-rv * c - iv * s).to(F32)                    # out[2k]
    odd = (-rv * s + iv * c).to(F32)                     # out[half - 1 - 2k]
    out = torch.empty((*x.shape[:-1], half), dtype=F32, device=x.device)
    out[..., 2 * k] = even
    out[..., half - 1 - 2 * k] = odd
    return out


def imdct(x: torch.Tensor, size: int, cdt=F64) -> torch.Tensor:
    """Inverse MDCT (mdct.js:139-211) at the codec's scale: [..., size/2]
    f32 -> [..., size] f32."""
    half, quarter = size >> 1, size >> 2
    fft_size = half >> 1
    n34 = 3 * quarter
    tbl = T.on("sincos_table", x.device, size, T.IMDCT_SCALES[size]).to(cdt)
    xv = x.to(cdt)
    i2 = 2 * torch.arange(fft_size, device=x.device)
    r = -xv[..., i2]
    s_ = -xv[..., half - 1 - i2]
    c, s = tbl[i2], tbl[i2 + 1]
    re, im = fft_js((s_ * s + r * c).to(F32), (s_ * c - r * s).to(F32), cdt)
    rv, iv = re.to(cdt), im.to(cdt)
    out = torch.empty((*x.shape[:-1], size), dtype=F32, device=x.device)
    i = torch.arange(fft_size // 2, device=x.device)
    c, s = tbl[2 * i], tbl[2 * i + 1]
    r1 = (rv[..., i] * c + iv[..., i] * s).to(F32)
    i1 = rv[..., i] * s - iv[..., i] * c
    out[..., n34 - 1 - 2 * i] = r1
    out[..., n34 + 2 * i] = r1
    out[..., quarter + 2 * i] = i1.to(F32)
    out[..., quarter - 1 - 2 * i] = (-i1).to(F32)
    i = torch.arange(fft_size // 2, fft_size, device=x.device)
    idx = (i - fft_size // 2) * 2 + quarter
    c, s = tbl[2 * i], tbl[2 * i + 1]
    r1 = rv[..., i] * c + iv[..., i] * s
    i1 = (rv[..., i] * s - iv[..., i] * c).to(F32)
    out[..., n34 - 1 - idx] = r1.to(F32)
    out[..., idx - quarter] = (-r1).to(F32)
    out[..., quarter + idx] = i1
    out[..., 5 * quarter - 1 - idx] = i1
    return out


def overlap_add(prev: torch.Tensor, curr: torch.Tensor, cdt=F64) -> torch.Tensor:
    """Windowed cross-fade (mdct.js:230-245): [..., 16] x2 -> [..., 32]."""
    t = prev.shape[-1]
    w = T.on("WINDOW_SHORT", prev.device).to(cdt)
    w1, w2 = w[:t], w[t:2 * t].flip(0)                    # w[i], w[2t-1-i]
    p, c = prev.to(cdt), curr.flip(-1).to(cdt)           # c[i] = curr[t-1-i]
    lo = (p * w2 - c * w1).to(F32)
    hi = (p * w1 + c * w2).to(F32)
    return torch.cat([lo, hi.flip(-1)], dim=-1)


def qmf_analysis(signal: torch.Tensor, delay: torch.Tensor, cdt=F64):
    """QMF analysis of a whole stream (qmf.js:19-50): signal [..., N] f32
    after the 46-sample delay line [..., 46] -> (low, high [..., N/2],
    new delay).  The 24 taps of each phase are summed in their order."""
    work = torch.cat([delay, signal], dim=-1)
    wv = work.to(cdt)
    n_out = signal.shape[-1] >> 1
    even = torch.zeros((*signal.shape[:-1], n_out), dtype=cdt, device=signal.device)
    odd = torch.zeros_like(even)               # 0 + x, as the reference starts its sums
    for j in range(24):
        even = even + wv[..., 47 - 2 * j: 47 - 2 * j + 2 * n_out: 2] * float(T.QMF_EVEN[j])
        odd = odd + wv[..., 46 - 2 * j: 46 - 2 * j + 2 * n_out: 2] * float(T.QMF_ODD[j])
    return (even + odd).to(F32), (even - odd).to(F32), work[..., -T.QMF_DELAY:]


def qmf_synthesis(low: torch.Tensor, high: torch.Tensor, delay: torch.Tensor, cdt=F64):
    """QMF synthesis of a whole stream (qmf.js:60-105): low, high [..., S]
    f32, delay [..., 46] -> (out [..., 2S] f32, new delay)."""
    s = low.shape[-1]
    lv, hv = low.to(cdt), high.to(cdt)
    merged = torch.stack([(0.5 * (lv + hv)).to(F32), (0.5 * (lv - hv)).to(F32)], dim=-1).reshape(*low.shape[:-1], 2 * s)
    work = torch.cat([delay, merged], dim=-1)
    wv = work.to(cdt)
    s0 = torch.zeros((*low.shape[:-1], s), dtype=cdt, device=low.device)
    s1 = torch.zeros_like(s0)
    for j in range(24):
        s0 = s0 + wv[..., 2 * j: 2 * j + 2 * s: 2] * float(T.QMF_EVEN[j])
        s1 = s1 + wv[..., 2 * j + 1: 2 * j + 1 + 2 * s: 2] * float(T.QMF_ODD[j])
    out = torch.stack([s1.to(F32), s0.to(F32)], dim=-1).reshape(*low.shape[:-1], 2 * s)
    return out, work[..., -T.QMF_DELAY:]
