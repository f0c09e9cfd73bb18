"""The reference decoder (codec/pipeline/decoder.js), plain PyTorch.

Fields -> dequantized spectra -> per band the inverse MDCT of the long
block or of each short block, overlap-added with the 16-sample tail of the
frame before -> the high band delayed by 39 samples -> two QMF syntheses
-> PCM, f32, and the reference's WAV conversion to int16.  Rows (one
stream each) ride the leading axis; the state carries the tails and delay
lines from one call to the next, so a stream decoded in chunks gives the
same samples as one decoded whole.
"""

from __future__ import annotations

import torch

from benchmark.reference import tables as T
from benchmark.reference.transforms import F32, F64, imdct, overlap_add, qmf_synthesis


def init_state(rows: int, device) -> dict[str, torch.Tensor]:
    z = lambda n: torch.zeros((rows, n), dtype=F32, device=device)  # noqa: E731
    return {"tail0": z(T.TAIL), "tail1": z(T.TAIL), "tail2": z(T.TAIL),
            "low": z(T.QMF_DELAY), "mid": z(T.QMF_DELAY), "high": z(T.QMF_HIGH_BAND_DELAY)}


def dequantize(q: torch.Tensor, sf: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """quantization.js:65-78: q * scale / range in float64, stored f32; zero
    where the word length or the scale factor index is 0."""
    rng = T.on("QUANT_RANGES", q.device)[wl]
    active = (rng > 0) & (sf > 0)
    scale = torch.where(active, T.on("SCALE_FACTORS", q.device)[sf], 0.0).to(F64)
    d = torch.where(rng > 0, rng, 1).to(F64)
    return (q.to(F64) * scale[..., None] / d[..., None]).to(F32)


def spectra(f: dict[str, torch.Tensor]) -> torch.Tensor:
    """Fields [..., F, ...] -> [..., F, 512] f32 coefficients (decoder.js:52-98)."""
    dev = f["q"].device
    deq = dequantize(f["q"], f["sf"], f["wl"])
    on = torch.arange(T.NUM_BFUS, device=dev) < f["n_bfu"][..., None]
    flat = torch.where(on[..., None], deq, 0.0).flatten(-2)                   # [..., F, 1040]
    band = torch.tensor([0] * 128 + [1] * 128 + [2] * 256, device=dev)
    short = (f["modes"][..., band] != 0).long()                                # [..., F, 512]
    slot = T.on("BFU_SCATTER", dev)[short, torch.arange(512, device=dev)]
    return torch.gather(flat, -1, slot)


def _band(coeffs: torch.Tensor, b: int, short: torch.Tensor, tail0: torch.Tensor):
    """One band of every frame of every row (decoder.js:116-330): coeffs
    [R, F, size], short [R, F] bool, tail0 [R, 16] -> (out [R, F, size],
    the last frame's tail)."""
    rows, nframes, size = coeffs.shape
    nb, t = T.SHORT_BLOCKS[b], T.TAIL
    spec_long = coeffs.flip(-1) if b > 0 else coeffs
    inv_long = imdct(spec_long, 2 * size)[..., size // 2: size // 2 + size]
    blocks = coeffs.reshape(rows, nframes, nb, 32)
    if b > 0:
        blocks = blocks.flip(-1)
    inv_short = imdct(blocks, 64)[..., 16:48].reshape(rows, nframes, size)
    buf = torch.where(short[..., None], inv_short, inv_long)
    tails = buf[..., size - t:]
    prev = torch.cat([tail0[:, None], tails[:, :-1]], 1)                      # [R, F, 16]
    out_long = torch.cat([overlap_add(prev, buf[..., :t]), buf[..., t:size - t]], -1)
    pieces, p = [], prev
    for k in range(nb):
        s = 32 * k
        pieces.append(overlap_add(p, buf[..., s:s + t]))
        p = buf[..., s + t:s + 32]
    out = torch.where(short[..., None], torch.cat(pieces, -1), out_long)
    return out, tails[:, -1]


def decode(f: dict[str, torch.Tensor], state: dict) -> tuple[torch.Tensor, dict]:
    """Fields of [R, F] frames -> (PCM f32 [R, F, 512], new state)."""
    coeffs = spectra(f)
    rows, nframes = coeffs.shape[:2]
    outs, new = [], {}
    for b, (lo, hi) in enumerate(zip(T.BAND_OFFSETS[:-1], T.BAND_OFFSETS[1:])):
        out, new[f"tail{b}"] = _band(coeffs[..., lo:hi], b, f["modes"][..., b] != 0, state[f"tail{b}"])
        outs.append(out.reshape(rows, -1))
    shifted = torch.cat([state["high"], outs[2]], -1)
    high = shifted[:, :outs[2].shape[1]]
    new["high"] = shifted[:, outs[2].shape[1]:]
    stage, new["mid"] = qmf_synthesis(outs[0], outs[1], state["mid"])
    pcm, new["low"] = qmf_synthesis(stage, high, state["low"])
    return pcm.reshape(rows, nframes, 512), new


def to_int16(pcm: torch.Tensor) -> torch.Tensor:
    """The reference's WAV writer (processor.js:347-426): clamp to [-1, 1]
    in f64, x32768 below zero and x32767 above, truncated toward zero."""
    x = pcm.double().clamp(-1.0, 1.0)
    return torch.where(x < 0, x * 32768.0, x * 32767.0).trunc().to(torch.int16)
