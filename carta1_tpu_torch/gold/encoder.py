"""The exact encoder: units byte-equal to the reference's, on the card.

The port of `carta1_tpu/gold/encoder.py` (codec/pipeline/encoder.js),
batched over a leading channel axis as well as the frames (gold encodes
one channel per call).  Every step is gold's arithmetic, f64 compute with
an f32 store where the reference stores into a Float32Array, as PyTorch
ops that each round once, or a hand kernel that repeats it:

  * QMF analysis tree: `transforms.qmf_analysis_stream` twice (f64 taps in
    the reference's order, kernel K8), the high band through the 39-sample
    delay;
  * block modes: the FFT magnitude of every band (kernel K6) and
    `transient.transient_score` (left-to-right f64 sums) against the
    thresholds of `EncoderOptions.band_thresholds`;
  * windowed MDCT: long blocks for every frame and short blocks where the
    band's mode is short (K6, the short rows masked on the card), selected
    per frame, the f64 window products stored to f32, the mid and high
    bands' spectra reversed;
  * BFU grouping (`ops/coding`), gold's scale factors (`gold/coding`: 63
    for a NaN peak, where the batched engine's `ops/coding` gives 0), the
    reference's heap allocation (kernel K5) and gold's f64 quantizer.

On non-finite input the units are specified only as far as the scale
factors: gold's `quantize_js` casts a NaN to int64, which NumPy leaves
undefined, so gold itself has no defined word past them.

The stream state has gold's keys (those of the batched engine), so a
checkpoint holds the JAX package's per-channel arrays.
"""

from __future__ import annotations

import functools

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import profiling
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.gold.coding import allocate_bits_sf, find_scale_factors, quantize_js
from carta1_tpu_torch.gold.fftjs import magnitude_spectrum_js
from carta1_tpu_torch.gold.transforms import mdct, mdct_masked, qmf_analysis_stream
from carta1_tpu_torch.gold.transient import transient_score
from carta1_tpu_torch.ops.coding import group_bfus
from carta1_tpu_torch.ops.common import shift_frames
from carta1_tpu_torch.ops.qmf import delay_stream
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.pipeline.encoder import encode_entry, encoder_init_state

__all__ = ["analysis_bands", "encoder_init_state", "exact_analysis", "exact_encode_step", "gold_encode_frames",
           "mdct_inputs"]


@functools.lru_cache(maxsize=None)
def _windows(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ascending, descending) f64 half-sine windows [32]."""
    w = torch.from_numpy(C.WINDOW_SHORT.copy()).to(device)
    return w, w.flip(0)


def analysis_bands(pcm: torch.Tensor, state: dict, plain: bool = False) -> tuple[list, dict]:
    """Two-level QMF tree (encoder.js:57-96): [..., F, 512] -> bands
    [..., F, 128], [..., F, 128], [..., F, 256] and the new delays; K8 for
    the taps of each level (its plain version with `plain=True`)."""
    lead, nframes = pcm.shape[:-2], pcm.shape[-2]
    low1, high1, low_d = qmf_analysis_stream(pcm.reshape(*lead, -1), state["qmf_low_delay"], plain=plain)
    low2, mid2, mid_d = qmf_analysis_stream(low1, state["qmf_mid_delay"], plain=plain)
    band2, high_d = delay_stream(high1.reshape(*lead, nframes, 256), state["qmf_high_delay"])
    bands = [low2.reshape(*lead, nframes, 128), mid2.reshape(*lead, nframes, 128), band2]
    return bands, {"qmf_low_delay": low_d, "qmf_mid_delay": mid_d, "qmf_high_delay": high_d}


def _block_modes(bands: list, thresholds: tuple, state: dict, plain: bool) -> tuple[torch.Tensor, list, dict]:
    """Per-band transient detection (encoder.js:111-145): int32 modes
    [..., F, 3], the f64 scores [..., F] per band, the new spectra.  Bands
    0 and 1 share their FFT size and run as one batch."""
    s01 = magnitude_spectrum_js(torch.stack([bands[0], bands[1]]), C.TRANSIENT_FFT_SIZES[0], plain)
    specs = [s01[0], s01[1], magnitude_spectrum_js(bands[2], C.TRANSIENT_FFT_SIZES[2], plain)]
    prevs = [shift_frames(specs[b], state[f"prev_spectrum{b}"]) for b in range(3)]
    score01 = transient_score(s01, torch.stack([prevs[0], prevs[1]]))
    scores = [score01[0], score01[1], transient_score(specs[2], prevs[2])]
    modes = torch.stack([torch.where(scores[b] > thresholds[b], max(b + 1, 2), 0) for b in range(3)], dim=-1)
    new_state = {f"prev_spectrum{b}": specs[b][..., -1, :] for b in range(3)}
    return modes.to(torch.int32), scores, new_state


def mdct_inputs(bands: list, state: dict) -> tuple[list, torch.Tensor, dict]:
    """The windowed MDCT inputs of the three bands (encoder.js:163-341):
    the long blocks [..., F, tsize] per band, the short blocks of all bands
    [..., F, 4 + 4 + 8, 64], and the new raw band tails."""
    w_up, w_down = _windows(bands[0].device)
    long_in, short_in, tails = [], [], {}
    for b, band in enumerate(bands):
        size, tsize, ws = C.MDCT_BAND_SIZES[b], C.MDCT_TRANSFORM_SIZES[b], C.MDCT_WINDOW_START[b]
        lead = band.shape[:-1]
        # the previous frame's raw tail, up-windowed (encoder.js:302-309)
        overlap = (shift_frames(band[..., size - 32:], state[f"band_tail{b}"]).double() * w_up).float()
        down = (band[..., size - 32:].double() * w_down).float()
        zeros = lambda n: torch.zeros((*lead, n), dtype=torch.float32, device=band.device)  # noqa: E731
        long_in.append(torch.cat([zeros(ws), overlap, band[..., :size - 32], down, zeros(tsize - ws - 32 - size)], -1))
        blocks = band.reshape(*lead, C.MDCT_NUM_SHORT_BLOCKS[b], 32)
        ov = torch.cat([overlap.unsqueeze(-2), (blocks[..., :-1, :].double() * w_up).float()], dim=-2)
        short_in.append(torch.cat([ov, (blocks.double() * w_down).float()], dim=-1))   # [..., nb, 64]
        tails[f"band_tail{b}"] = band[..., -1, size - 32:]
    return long_in, torch.cat(short_in, dim=-2), tails


def short_block_mask(modes: torch.Tensor) -> torch.Tensor:
    """bool [..., F, 16]: which of a frame's 4 + 4 + 8 short blocks belong to
    a band in a short mode (int32 modes [..., F, 3] != 0), in the order of
    `mdct_inputs`' short blocks."""
    is_short = (modes != 0).unsqueeze(-1)                                   # [..., F, 3, 1]
    return torch.cat([is_short[..., b, :].expand(*is_short.shape[:-2], n)
                      for b, n in enumerate(C.MDCT_NUM_SHORT_BLOCKS)], dim=-1)


def _mdct_bands(bands: list, modes: torch.Tensor, state: dict, plain: bool) -> tuple[torch.Tensor, dict]:
    """Windowed MDCT of the three bands: [..., F, 512] coefficients and the
    new raw band tails.  The long blocks of every frame and the short
    blocks of the frames whose band is in a short mode are transformed
    (the other short rows are masked: zeros that the mode never selects),
    and each frame takes one by its mode, as in gold; the long blocks of
    bands 0 and 1 and the short blocks of all bands run as one batch each."""
    long_in, short_in, tails = mdct_inputs(bands, state)
    spec01 = mdct(torch.stack(long_in[:2]), C.MDCT_TRANSFORM_SIZES[0], plain)
    spec_long = [spec01[0], spec01[1].flip(-1), mdct(long_in[2], C.MDCT_TRANSFORM_SIZES[2], plain).flip(-1)]
    spec_short = mdct_masked(short_in, short_block_mask(modes), plain).split(list(C.MDCT_NUM_SHORT_BLOCKS), dim=-2)
    coeffs = []
    for b in range(3):
        short = spec_short[b] if b == 0 else spec_short[b].flip(-1)
        short = short.reshape(spec_long[b].shape)
        coeffs.append(torch.where((modes[..., b] == 0).unsqueeze(-1), spec_long[b], short))
    return torch.cat(coeffs, dim=-1), tails


def exact_analysis(pcm: torch.Tensor, state: dict, options: EncoderOptions, plain: bool = False):
    """The exact encoder up to the allocator: f32 [..., F, 512] -> (BFU
    slots f32 [..., F, 52, 20], scale factors int32 [..., F, 52], block
    modes int32 [..., F, 3], the three bands' transient scores f64
    [..., F], new state)."""
    with profiling.span("carta1.encode.analysis"):
        with profiling.span("carta1.encode.qmf"):
            bands, new_state = analysis_bands(pcm, state, plain)
        with profiling.span("carta1.encode.transient"):
            modes, scores, spec_state = _block_modes(bands, options.band_thresholds, state, plain)
        with profiling.span("carta1.encode.mdct"):
            coeffs, tails = _mdct_bands(bands, modes, state, plain)
        with profiling.span("carta1.encode.scale_factors"):
            bfu = group_bfus(coeffs, modes)
            sf = find_scale_factors(bfu)
    return bfu, sf, modes, scores, {**new_state, **spec_state, **tails}


def exact_encode_step(pcm: torch.Tensor, state: dict, options: EncoderOptions,
                      plain: bool = False) -> tuple[FrameData, dict]:
    """Exact batched encode of f32 [..., F, 512] (F > 0) -> (FrameData, state).
    `plain=True` runs K5's, K6's and K8's plain versions on any device."""
    bfu, sf, modes, _, new_state = exact_analysis(pcm, state, options, plain)
    with profiling.span("carta1.encode.allocate"):
        wl = allocate_bits_sf(sf, options.allocation_bias, plain)
    lead = sf.shape[:-1]
    with profiling.span("carta1.encode.quantize"):
        fd = FrameData(
            n_bfu=torch.full(lead, C.NUM_BFUS, dtype=torch.int32, device=pcm.device),
            block_modes=modes,
            scale_factors=sf,
            word_lengths=wl,
            quantized=quantize_js(bfu, sf, wl),
        )
        new_state = {k: new_state[k].clone() for k in state}     # no view keeps a chunk's tensors alive
    return fd, new_state


def gold_encode_frames(pcm, options: EncoderOptions | None = None, state: dict | None = None, device=None,
                       plain: bool = False) -> tuple[FrameData, dict]:
    """Public entry: the exact encode of [..., F, 512] f32 PCM (NumPy or
    tensor; a leading axis batches channels) on `device` (default: the card).
    On non-finite input the units are gold's only up to the scale factors
    (the module docstring)."""
    return encode_entry(pcm, options, state, device, lambda x, st, o: exact_encode_step(x, st, o, plain))
