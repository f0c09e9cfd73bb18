"""The reference encoder (codec/pipeline/encoder.js), plain PyTorch.

PCM f32 [R, F, 512] -> QMF tree (two analyses, the high band delayed by
39 samples) -> per band the transient detector's block mode -> the
windowed MDCT of the long block or of each short block -> 52 BFUs ->
scale factors -> the reference's heap allocation -> the quantizer.  Rows
are streams; the state carries the delay lines, the last spectra and the
last raw band tails from one call to the next.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bitstream
from benchmark.reference import tables as T
from benchmark.reference.transforms import F32, F64, magnitude_spectrum, mdct, qmf_analysis


def init_state(rows: int, device) -> dict[str, torch.Tensor]:
    z = lambda n: torch.zeros((rows, n), dtype=F32, device=device)  # noqa: E731
    return {"low": z(T.QMF_DELAY), "mid": z(T.QMF_DELAY), "high": z(T.QMF_HIGH_BAND_DELAY),
            "spec0": z(64), "spec1": z(64), "spec2": z(128), "tail0": z(32), "tail1": z(32), "tail2": z(32)}


def _seqsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis, one rounding per addition."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def transient_score(cur: torch.Tensor, prev: torch.Tensor, cdt=F64) -> torch.Tensor:
    """transient.js:44-226: spectral flux, flatness change, change of the
    high-frequency share and rise of energy, each from sequential sums."""
    c, p = cur.to(cdt), prev.to(cdt)
    diff = c.abs() - p.abs()
    flux = _seqsum(torch.where(diff > 0, diff, 0.0))
    norm = torch.sqrt(_seqsum(c.abs() * c.abs()))
    flux = flux / torch.where(norm == 0.0, 1e-6, norm)

    def flatness(m):
        valid = m.abs() > 1e-10
        n = valid.sum(-1)
        sum_log = _seqsum(torch.where(valid, torch.log(torch.where(valid, m.abs(), 1.0)), 0.0))
        sum_lin = _seqsum(torch.where(valid, m.abs(), 0.0))
        n_safe = n.clamp(min=1).to(cdt)
        geo = torch.exp(sum_log / n_safe)
        arith = sum_lin / n_safe
        flat = torch.where(arith > 1e-10, geo / torch.where(arith > 0, arith, 1.0), 0.0)
        return torch.where(n == 0, 0.0, flat)

    def hf_ratio(m):
        mid = m.shape[-1] // 2
        low = _seqsum(m[..., :mid] * m[..., :mid])
        high = _seqsum(m[..., mid:] * m[..., mid:])
        total = low + high
        return torch.where(total > 0, high / torch.where(total > 0, total, 1.0), 0.0)

    flat_change = (flatness(c) - flatness(p)).abs()
    hf_change = (hf_ratio(c) - hf_ratio(p)).abs()
    ce = _seqsum(c * c).clamp(min=1e-10)
    pe = _seqsum(p * p).clamp(min=1e-10)
    energy = (10.0 * torch.log10(ce / pe)).clamp(min=0.0)
    return (flux + torch.sqrt(flat_change) + torch.log1p(hf_change * 10.0) / math.log1p(10.0)
            + (energy / 30.0).clamp(max=1.0)) / 4.0


def analysis(pcm: torch.Tensor, state: dict, thresholds: tuple, cdt=F64, modes: torch.Tensor | None = None):
    """The encoder up to the allocator: pcm f32 [R, F, 512] -> (BFU slots
    f32 [R, F, 52, 20], block modes int64 [R, F, 3], transient scores
    [R, F, 3], new state).  `modes`, where given, replaces the detector's
    choice in the MDCT stage (to judge coefficients in another encoder's
    modes); the state is the same either way."""
    rows, nframes = pcm.shape[:2]
    low1, high1, d_low = qmf_analysis(pcm.reshape(rows, -1), state["low"], cdt)
    low2, mid2, d_mid = qmf_analysis(low1, state["mid"], cdt)
    shifted = torch.cat([state["high"], high1], -1)
    band2, d_high = shifted[:, :high1.shape[1]], shifted[:, high1.shape[1]:]
    bands = [low2.reshape(rows, nframes, 128), mid2.reshape(rows, nframes, 128), band2.reshape(rows, nframes, 256)]
    new = {"low": d_low, "mid": d_mid, "high": d_high}

    own, scores = [], []
    for b in range(3):
        spec = magnitude_spectrum(bands[b], T.TRANSIENT_FFT_SIZES[b], cdt)
        prev = torch.cat([state[f"spec{b}"][:, None], spec[:, :-1]], 1)
        scores.append(transient_score(spec, prev, cdt))
        own.append(torch.where(scores[-1] > thresholds[b], max(b + 1, 2), 0))
        new[f"spec{b}"] = spec[:, -1]
    own = torch.stack(own, -1)
    use = own if modes is None else modes

    w_up = T.on("WINDOW_SHORT", pcm.device).to(cdt)
    w_down = w_up.flip(0)
    coeffs = []
    for b, band in enumerate(bands):
        size, tsize, ws, nb = T.BAND_SIZES[b], T.TRANSFORM_SIZES[b], T.WINDOW_START[b], T.SHORT_BLOCKS[b]
        prev_tail = torch.cat([state[f"tail{b}"][:, None], band[:, :-1, size - 32:]], 1)
        overlap = (prev_tail.to(cdt) * w_up).to(F32)
        down = (band[..., size - 32:].to(cdt) * w_down).to(F32)
        zeros = lambda n: torch.zeros((rows, nframes, n), dtype=F32, device=pcm.device)  # noqa: E731
        long_in = torch.cat([zeros(ws), overlap, band[..., :size - 32], down, zeros(tsize - ws - 32 - size)], -1)
        spec_long = mdct(long_in, tsize, cdt)
        blocks = band.reshape(rows, nframes, nb, 32)
        ov = torch.cat([overlap[:, :, None], (blocks[:, :, :-1].to(cdt) * w_up).to(F32)], 2)
        short_in = torch.cat([ov, (blocks.to(cdt) * w_down).to(F32)], -1)
        spec_short = mdct(short_in, 64, cdt)
        if b > 0:
            spec_long, spec_short = spec_long.flip(-1), spec_short.flip(-1)
        coeffs.append(torch.where(use[..., b, None] == 0, spec_long, spec_short.reshape(rows, nframes, size)))
        new[f"tail{b}"] = band[:, -1, size - 32:]
    coeffs = torch.cat(coeffs, -1)
    return group(coeffs, use), own, torch.stack(scores, -1), new


def group(coeffs: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """[..., 512] spectra -> [..., 52, 20] BFU slots, zero padding
    (quantization.js:106-149)."""
    dev = coeffs.device
    short = (modes[..., T.on("BFU_BAND", dev)] != 0).long()                   # [..., 52]
    idx = T.on("BFU_GATHER", dev)[short, torch.arange(T.NUM_BFUS, device=dev)]   # [..., 52, 20]
    got = torch.gather(coeffs, -1, idx.clamp(min=0).flatten(-2)).reshape(idx.shape)
    return torch.where(idx >= 0, got, 0.0)


def peaks(bfu: torch.Tensor) -> torch.Tensor:
    """The largest magnitude of each BFU's coefficients, f64."""
    return torch.where(T.on("SLOT_MASK", bfu.device), bfu.double().abs(), 0.0).amax(-1)


def scale_factors(bfu: torch.Tensor) -> torch.Tensor:
    """bitallocation.js:172-181: ceil(3 (log2 peak + 21)) clipped to 0..63,
    0 for a silent BFU."""
    peak = peaks(bfu)
    idx = torch.ceil(3.0 * (torch.log2(torch.where(peak > 0, peak, 1.0)) + 21.0)).clamp(0, 63).long()
    return torch.where(peak == 0.0, 0, idx)


def quantize(bfu: torch.Tensor, sf: torch.Tensor, wl: torch.Tensor, cdt=F64) -> torch.Tensor:
    """quantization.js:34-56: x = coefficient * range / scale, rounded half
    away from zero by truncation, clipped to the range."""
    dev = bfu.device
    rng = T.on("QUANT_RANGES", dev)[wl]
    active = (rng > 0) & (sf > 0)
    scale = T.on("SCALE_FACTORS", dev)[sf]
    norm = torch.where(active, rng.double() / torch.where(scale > 0, scale, 1.0), 0.0).to(cdt)
    x = bfu.to(cdt) * norm[..., None]
    y = torch.trunc(x + torch.where(x >= 0, 0.5, -0.5)).long()
    y = torch.minimum(torch.maximum(y, -rng[..., None]), rng[..., None])
    return torch.where(active[..., None], y, 0)


def encode(pcm: torch.Tensor, state: dict, thresholds: tuple, bias: float, cdt=F64):
    """The whole reference encoder: pcm f32 [R, F, 512] -> (units uint8
    [R, F, 212], new state)."""
    bfu, modes, _, state = analysis(pcm, state, thresholds, cdt)
    sf = scale_factors(bfu)
    wl = allocate_heap(sf.reshape(-1, T.NUM_BFUS), bias).reshape(sf.shape)
    f = {"n_bfu": torch.full(sf.shape[:2], T.NUM_BFUS, device=pcm.device), "modes": modes, "wl": wl, "sf": sf,
         "q": quantize(bfu, sf, wl, cdt)}
    units = bitstream.pack({n: v.flatten(0, 1) for n, v in f.items()})
    return units.reshape(*sf.shape[:2], T.SOUND_UNIT_SIZE), state


# ---------------------------------------------------------------------------
# The reference's allocator: a max-heap per frame (bitallocation.js:44-164)
# ---------------------------------------------------------------------------
def priority_table(bias: float) -> np.ndarray:
    """f64 [64, 16]: the priority of the step from word length w to w + 1
    at scale factor s, in the reference's Python-float order of operations
    (eff * (f1 - f2) / (b2 - b1)); row 15 is unused."""
    wlb, inv = T.WORD_LENGTH_BITS, T.INV_POWER_OF_TWO
    out = np.zeros((64, 16))
    for s in range(64):
        eff = float(T.SCALE_FACTORS[s]) ** bias
        for w in range(15):
            b1, b2 = int(wlb[w]), int(wlb[w + 1])
            f1 = 2.0 if b1 == 0 else float(inv[b1])
            out[s, w] = eff * (f1 - float(inv[b2])) / (b2 - b1)
    return out


def allocate_heap(sf: torch.Tensor, bias: float) -> torch.Tensor:
    """Word lengths int64 [N, 52] for scale factors [N, 52], every frame's
    heap run in lockstep: the same pushes, pops, sift-downs and strict
    comparisons as the reference, so its ties break as the reference's do."""
    dev = sf.device
    n = sf.shape[0]
    prio_tab = torch.from_numpy(priority_table(bias)).to(dev)
    wlb = T.on("WORD_LENGTH_BITS", dev)
    specs = T.on("SPECS_PER_BFU", dev)
    rows = torch.arange(n, device=dev)
    wl = torch.zeros((n, T.NUM_BFUS), dtype=torch.long, device=dev)
    # the heap array: the BFUs with a nonzero scale factor, in BFU order
    live = sf > 0
    size = live.sum(1)
    order = torch.sort((~live).long() * 64 + torch.arange(T.NUM_BFUS, device=dev), dim=1, stable=True).indices
    h_idx = order.clone()
    in_heap = torch.arange(T.NUM_BFUS, device=dev) < size[:, None]
    h_pri = torch.where(in_heap, prio_tab[sf.gather(1, order), 0], -math.inf)

    def sift_down(start: torch.Tensor, mask: torch.Tensor) -> None:
        """Sift the entry at `start` down, in the frames under `mask`."""
        i = start.clone()
        iv, pv = h_idx[rows, i], h_pri[rows, i]
        going = mask.clone()
        while bool(going.any()):
            left, right = 2 * i + 1, 2 * i + 2
            lp = h_pri[rows, left.clamp(max=T.NUM_BFUS - 1)]
            rp = h_pri[rows, right.clamp(max=T.NUM_BFUS - 1)]
            mi, mp = i.clone(), pv.clone()
            take_l = (left < size) & (lp > mp)
            mi, mp = torch.where(take_l, left, mi), torch.where(take_l, lp, mp)
            take_r = (right < size) & (rp > mp)
            mi = torch.where(take_r, right, mi)
            moves = going & (mi != i)
            src = mi.clamp(max=T.NUM_BFUS - 1)
            h_idx[rows[moves], i[moves]] = h_idx[rows[moves], src[moves]]
            h_pri[rows[moves], i[moves]] = h_pri[rows[moves], src[moves]]
            i = torch.where(moves, mi, i)
            going = moves
        h_idx[rows[mask], i[mask]] = iv[mask]
        h_pri[rows[mask], i[mask]] = pv[mask]

    def pop_root(mask: torch.Tensor) -> None:
        last = (size - 1).clamp(min=0)
        h_idx[rows[mask], 0] = h_idx[rows[mask], last[mask]]
        h_pri[rows[mask], 0] = h_pri[rows[mask], last[mask]]
        h_pri[rows[mask], last[mask]] = -math.inf
        size.sub_(mask.long())
        sift_down(torch.zeros_like(size), mask & (size > 0))

    for start in range(T.NUM_BFUS // 2 - 1, -1, -1):            # heapify
        sift_down(torch.full_like(size, start), start < size // 2)

    remaining = torch.full((n,), T.BUDGET_BITS, dtype=torch.long, device=dev)
    while True:
        act = (remaining > 0) & (size > 0)
        if not bool(act.any()):
            return wl
        bfu = h_idx[:, 0]
        cur = wl[rows, bfu]
        nxt = (cur + 1).clamp(max=15)
        cost = (wlb[nxt] - wlb[cur]) * specs[bfu]
        drop = act & ((cost > remaining) | (cost <= 0))
        take = act & ~drop
        remaining = torch.where(take, remaining - cost, remaining)
        wl[rows[take], bfu[take]] = nxt[take]
        more = take & (nxt < 15)
        h_pri[rows[more], 0] = prio_tab[sf[rows, bfu], nxt][more]
        sift_down(torch.zeros_like(size), more)
        pop_root(drop | (take & ~more))
