"""The batched engine's allocator as its contract states it, plain PyTorch.

The engine's default allocator ("rdo") prices every step of a BFU's word
length, w -> w + 1, by the squared quantization error it removes per bit,
makes the prices of each BFU non-increasing in w (its upper concave hull:
a running maximum from the top), and takes the steps of all BFUs in one
sweep by descending price (ties in BFU, then word-length order).  A BFU
whose next step no longer fits the frame's 1,136 bits is abandoned; the
cheaper steps of other BFUs go on.  With bias b the errors of a BFU are
weighted by its scale factor to the power b - 1.

Here the errors are computed in float64 from the reference's own
coefficients; the engine computes them in float32 from its own, so near
ties may fall the other way.  The comparison counts the frames where
they do.
"""

from __future__ import annotations

import torch

from benchmark.reference import tables as T

F64 = torch.float64


def allocate(bfu: torch.Tensor, sf: torch.Tensor, bias: float) -> torch.Tensor:
    """Word lengths int64 [N, 52] for BFU slots f32 [N, 52, 20] and scale
    factor indices [N, 52]."""
    dev = bfu.device
    n = bfu.shape[0]
    rng = T.on("QUANT_RANGES", dev).to(F64)                                   # [16]
    scale = T.on("SCALE_FACTORS", dev)[sf].to(F64)                             # [N, 52]
    on = (sf > 0)[..., None] & (rng > 0)                                       # [N, 52, 16]
    norm = torch.where(on, rng / scale[..., None], 0.0)
    step = torch.where(on, scale[..., None] / rng.clamp(min=1.0), 0.0)
    data = torch.where(T.on("SLOT_MASK", dev), bfu.to(F64), 0.0)               # [N, 52, 20]
    err = torch.empty((n, T.NUM_BFUS, 16), dtype=F64, device=dev)
    for w in range(16):
        x = data * norm[..., w:w + 1]
        q = torch.trunc(x + torch.where(x >= 0, 0.5, -0.5)).clamp(-rng[w], rng[w])
        d = data - q * step[..., w:w + 1]
        err[..., w] = (d * d).sum(-1)
    if bias != 1.0:
        err = err * (scale ** (bias - 1.0))[..., None]
    wlb = T.on("WORD_LENGTH_BITS", dev)
    step_bits = wlb[1:] - wlb[:-1]                                              # [15]
    specs = T.on("SPECS_PER_BFU", dev)
    slope = (err[..., :-1] - err[..., 1:]) / (step_bits * specs[:, None]).to(F64)
    prio = slope.flip(-1).cummax(-1).values.flip(-1)                           # hull: max over w' >= w
    valid = (sf > 0)[..., None] & (prio > 0)
    key = torch.where(valid, prio, -torch.inf).reshape(n, -1)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices       # [N, 780]
    cand_bfu = order // 15
    cand_cost = (step_bits[order % 15] * specs[cand_bfu])
    cand_ok = valid.reshape(n, -1).gather(1, order)
    rows = torch.arange(n, device=dev)
    wl = torch.zeros((n, T.NUM_BFUS), dtype=torch.long, device=dev)
    dropped = torch.zeros((n, T.NUM_BFUS), dtype=torch.bool, device=dev)
    remaining = torch.full((n,), T.BUDGET_BITS, dtype=torch.long, device=dev)
    for c in range(order.shape[1]):
        b, cost = cand_bfu[:, c], cand_cost[:, c]
        live = cand_ok[:, c] & ~dropped[rows, b]
        fits = live & (cost <= remaining)
        dropped[rows, b] |= live & ~fits
        remaining = torch.where(fits, remaining - cost, remaining)
        wl[rows, b] += fits.long()
    return wl
