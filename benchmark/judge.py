"""The comparison that decides `correct`: what the timed calls produced,
against the plain reference in `benchmark/reference/`.

The reference runs after the window, on the cell's own inputs (the PCM
the benchmark made from the seed, or for a decode cell the units made
from it at set-up), through every chunk of every track with its state
carried, a few rows at a time, on the same device.  Each sampled call's
output is compared with the reference's output for that call's chunk.

Three judges, named by the cell's limits file:

  * `decode`: the int16 PCM, sample for sample (the decoder is specified
    bit for bit): `pcm_diff_samples`.
  * `encode_exact`: the units, byte for byte (the exact engine's units
    equal the reference encoder's): `unit_diff_bytes`.
  * `encode_batched`: the batched engine computes its transforms in
    float32, so each field of its units is held to what the reference
    says of it: the units re-pack to themselves (`pack_diff_bytes`); no
    frame spends more than its 1,136 bits (`budget_over_frames`); the
    block modes of the reference's detector (`mode_diff_pct` of the
    band-frames); each scale factor brackets the reference's peak of its
    BFU (`sf_gap`, in scale-factor steps outside the bracket); the word
    lengths of the allocator's contract, `reference/rdo.py`, from the
    reference's coefficients (`wl_diff_pct` of the frames); each
    quantized value within half a step of the reference's coefficient
    (`q_gap`, steps beyond the half).

A decode cell's limits file may also name a judge under `units`: the
units it decodes, which the program's encoder made at set-up, are then
held to the reference as that judge holds an encode cell's outputs, and
its numbers are reported as `units.<name>`.
"""

from __future__ import annotations

import torch

from benchmark.reference import bitstream, decoder, encoder, rdo
from benchmark.reference import tables as T

ROWS_PER_BLOCK = 16


def thresholds(config: dict) -> tuple[float, float, float]:
    """The detector's thresholds: the reference compares every band with
    the low one (encoder.js:134) unless per-band thresholds are set."""
    o = config["options"]
    low = o.get("transient_threshold_low", 1.0)
    if not o.get("per_band_thresholds", False):
        return (low, low, low)
    return (low, o.get("transient_threshold_mid", 1.5), o.get("transient_threshold_high", 2.0))


def _fields(units: torch.Tensor) -> dict[str, torch.Tensor]:
    """Unpack [R, F, 212] -> fields with [R, F] leading axes."""
    rows, nframes = units.shape[:2]
    f = bitstream.unpack(units.reshape(-1, T.SOUND_UNIT_SIZE))
    return {k: v.reshape(rows, nframes, *v.shape[1:]) for k, v in f.items()}


def _decode(inputs, outputs, chunk_of, config) -> dict[str, float]:
    diff = 0
    chunks, rows = inputs.shape[:2]
    for r0 in range(0, rows, ROWS_PER_BLOCK):
        rs = slice(r0, r0 + ROWS_PER_BLOCK)
        state = decoder.init_state(inputs[0, rs].shape[0], inputs.device)
        for k in range(chunks):
            pcm, state = decoder.decode(_fields(inputs[k, rs]), state)
            ref = decoder.to_int16(pcm)
            for i, out in outputs.items():
                if chunk_of(i) == k:
                    diff += int((out[rs] != ref).sum())
    return {"pcm_diff_samples": diff}


def _encode_exact(inputs, outputs, chunk_of, config) -> dict[str, float]:
    diff = 0
    chunks, rows = inputs.shape[:2]
    bias = config["options"].get("allocation_bias", 1.0)
    for r0 in range(0, rows, ROWS_PER_BLOCK):
        rs = slice(r0, r0 + ROWS_PER_BLOCK)
        state = encoder.init_state(inputs[0, rs].shape[0], inputs.device)
        for k in range(chunks):
            units, state = encoder.encode(inputs[k, rs].float() / 32768.0, state, thresholds(config), bias)
            for i, out in outputs.items():
                if chunk_of(i) == k:
                    diff += int((out[rs] != units).sum())
    return {"unit_diff_bytes": diff}


def sf_gap(peak: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
    """How far, in scale-factor steps, the reference's value v = 3 (log2
    peak + 21) lies outside the bracket of the chosen index s: s - 1 < v
    <= s (v <= 0 for s = 0, v > 62 for s = 63).  A silent BFU (peak 0)
    must have s = 0; otherwise its gap is s."""
    v = 3.0 * (torch.log2(torch.where(peak > 0, peak, 1.0)) + 21.0)
    s = sf.double()
    above = torch.where(sf < 63, v - s, 0.0)
    below = torch.where(sf > 0, (s - 1.0) - v, 0.0)
    gap = torch.maximum(above, below).clamp(min=0.0)
    return torch.where(peak > 0, gap, s)


def q_gap(bfu: torch.Tensor, f: dict[str, torch.Tensor]) -> torch.Tensor:
    """Steps by which each quantized value lies beyond half a step of the
    reference coefficient scaled as the quantizer scales it (range /
    scale factor), clipped to the range; 0 where nothing is coded."""
    dev = bfu.device
    rng = T.on("QUANT_RANGES", dev)[f["wl"]]
    on = (rng > 0) & (f["sf"] > 0)
    scale = T.on("SCALE_FACTORS", dev)[f["sf"]]
    x = bfu.double() * torch.where(on, rng.double() / torch.where(scale > 0, scale, 1.0), 0.0)[..., None]
    r = rng.double()[..., None]
    x = torch.minimum(torch.maximum(x, -r), r)
    gap = ((f["q"].double() - x).abs() - 0.5).clamp(min=0.0)
    return torch.where(on[..., None] & T.on("SLOT_MASK", dev), gap, 0.0)


def _encode_batched(inputs, outputs, chunk_of, config) -> dict[str, float]:
    chunks, rows = inputs.shape[:2]
    bias = config["options"].get("allocation_bias", 1.0)
    tot = {"pack_diff_bytes": 0, "budget_over_frames": 0, "mode_diff": 0, "band_frames": 0,
           "sf_gap": 0.0, "wl_diff": 0, "frames": 0, "q_gap": 0.0}
    bits = T.on("WORD_LENGTH_BITS", inputs.device)
    specs = T.on("SPECS_PER_BFU", inputs.device)
    for r0 in range(0, rows, ROWS_PER_BLOCK):
        rs = slice(r0, r0 + ROWS_PER_BLOCK)
        state = encoder.init_state(inputs[0, rs].shape[0], inputs.device)
        for k in range(chunks):
            pcm = inputs[k, rs].float() / 32768.0
            after = None
            for i, out in outputs.items():
                if chunk_of(i) != k:
                    continue
                units = out[rs]
                f = _fields(units)
                lead = f["sf"].shape[:2]
                repack = bitstream.pack({n: v.flatten(0, 1) for n, v in f.items()}).reshape(units.shape)
                tot["pack_diff_bytes"] += int((repack != units).sum())
                used = (bits[f["wl"]] * specs).sum(-1)
                tot["budget_over_frames"] += int((used > T.BUDGET_BITS).sum())
                bfu, own, _, after = encoder.analysis(pcm, state, thresholds(config), modes=f["modes"])
                tot["mode_diff"] += int((own != f["modes"]).sum())
                tot["band_frames"] += own.numel()
                tot["sf_gap"] = max(tot["sf_gap"], float(sf_gap(encoder.peaks(bfu), f["sf"]).max()))
                wl = rdo.allocate(bfu.flatten(0, 1), f["sf"].flatten(0, 1), bias)
                tot["wl_diff"] += int((wl.reshape(f["wl"].shape) != f["wl"]).any(-1).sum())
                tot["frames"] += lead.numel()
                tot["q_gap"] = max(tot["q_gap"], float(q_gap(bfu, f).max()))
            if after is None:
                _, _, _, after = encoder.analysis(pcm, state, thresholds(config))
            state = after
    return {"pack_diff_bytes": tot["pack_diff_bytes"], "budget_over_frames": tot["budget_over_frames"],
            "mode_diff_pct": 100.0 * tot["mode_diff"] / max(tot["band_frames"], 1), "sf_gap": tot["sf_gap"],
            "wl_diff_pct": 100.0 * tot["wl_diff"] / max(tot["frames"], 1), "q_gap": tot["q_gap"]}


JUDGES = {"decode": _decode, "encode_exact": _encode_exact, "encode_batched": _encode_batched}


def judge(kind: str, inputs: torch.Tensor, outputs: dict, chunk_of, config: dict) -> dict:
    """The numbers `kind` compares, for `outputs` {call index: output} of
    the calls whose chunk is `chunk_of(index)`."""
    with torch.no_grad():
        return JUDGES[kind](inputs, outputs, chunk_of, config)
