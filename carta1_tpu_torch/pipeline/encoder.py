"""Batched encoder pipeline.

[..., F, 512] PCM -> FrameData: the QMF tree as strided convolutions,
transient detection as batched FFT features, the windowed MDCT as basis
products, a greedy rate-distortion allocation (kernel K4, one launch) and
the table-driven quantizer; the counterpart of `carta1_tpu/pipeline/encoder.py`.
The stream state uses the gold engine's keys, so the engines are
interchangeable mid-stream.  A leading channel axis on the PCM and the
state batches channels.

Reference pipeline: codec/pipeline/encoder.js:426-438.
"""

from __future__ import annotations

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import profiling
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.ops.bitalloc import allocate_bits, allocate_bits_rdo
from carta1_tpu_torch.ops.coding import find_scale_factors, group_bfus, quantize
from carta1_tpu_torch.ops.mdct import encoder_mdct_band
from carta1_tpu_torch.ops.qmf import delay_stream, qmf_analysis
from carta1_tpu_torch.ops.transient import block_modes
from carta1_tpu_torch.options import EncoderOptions

STATE_SIZES = {
    "qmf_low_delay": C.QMF_DELAY,
    "qmf_mid_delay": C.QMF_DELAY,
    "qmf_high_delay": C.QMF_HIGH_BAND_DELAY,
    "prev_spectrum0": C.TRANSIENT_FFT_SIZES[0] // 2,
    "prev_spectrum1": C.TRANSIENT_FFT_SIZES[1] // 2,
    "prev_spectrum2": C.TRANSIENT_FFT_SIZES[2] // 2,
    "band_tail0": 32,
    "band_tail1": 32,
    "band_tail2": 32,
}
STATE_KEYS = tuple(STATE_SIZES)


def encoder_init_state(device=None, channels: int | None = None) -> dict[str, torch.Tensor]:
    """Zero stream state (same keys and shapes as gold.encoder_init_state),
    with a leading [channels] axis when `channels` is given."""
    dev = resolve_device(device)
    lead = () if channels is None else (channels,)
    return {k: torch.zeros(lead + (n,), dtype=torch.float32, device=dev) for k, n in STATE_SIZES.items()}


def analysis_step(
    pcm: torch.Tensor, state: dict, thresholds: tuple
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """The encoder up to the allocator: pcm f32 [..., F, 512] -> (BFU slots
    f32 [..., F, 52, 20], scale factors int32 [..., F, 52], block modes
    int32 [..., F, 3], new state)."""
    # QMF analysis tree (encoder.js:57-96)
    low1, high1, low_d = qmf_analysis(pcm, state["qmf_low_delay"])
    low2, mid2, mid_d = qmf_analysis(low1, state["qmf_mid_delay"])
    band2, high_d = delay_stream(high1, state["qmf_high_delay"])
    bands = [low2, mid2, band2]

    # transient detection -> block modes (encoder.js:111-145)
    modes, new_specs = block_modes(bands, [state[f"prev_spectrum{b}"] for b in range(3)], thresholds)

    # windowed MDCT per band (encoder.js:163-341)
    parts, new_tails = [], []
    for b in range(3):
        cf, tail = encoder_mdct_band(bands[b], b, modes[..., b], state[f"band_tail{b}"])
        parts.append(cf)
        new_tails.append(tail)
    coeffs = torch.cat(parts, dim=-1)                                 # [..., F, 512]

    bfu = group_bfus(coeffs, modes)
    new_state = {
        "qmf_low_delay": low_d,
        "qmf_mid_delay": mid_d,
        "qmf_high_delay": high_d,
        "prev_spectrum0": new_specs[0],
        "prev_spectrum1": new_specs[1],
        "prev_spectrum2": new_specs[2],
        "band_tail0": new_tails[0],
        "band_tail1": new_tails[1],
        "band_tail2": new_tails[2],
    }
    return bfu, find_scale_factors(bfu), modes, new_state


def encode_step(
    pcm: torch.Tensor,
    state: dict,
    thresholds: tuple,
    allocation_bias: float,
    allocator: str = "rdo",
    plain: bool = False,
) -> tuple[FrameData, dict]:
    """Batched encode: pcm f32 [..., F, 512] -> (FrameData, state).

    allocator: "rdo" (default) prices word-length steps by the measured
    reduction of the quantization error; "reference" replicates the
    reference heap's proxy.  `plain=True` runs K4's plain PyTorch version."""
    bfu, sf, modes, new_state = analysis_step(pcm, state, thresholds)
    profiling.nan_check("encoder analysis spectra", bfu)

    # allocation and quantization (encoder.js:374-405)
    lead = sf.shape[:-1]
    if allocator == "rdo":
        wl = allocate_bits_rdo(bfu.reshape(-1, *bfu.shape[-2:]), sf.reshape(-1, C.NUM_BFUS), allocation_bias, plain=plain)
    else:
        wl = allocate_bits(sf.reshape(-1, C.NUM_BFUS), allocation_bias, plain=plain)
    wl = wl.reshape(*lead, C.NUM_BFUS)
    q = quantize(bfu, sf, wl)

    fd = FrameData(
        n_bfu=torch.full(lead, C.NUM_BFUS, dtype=torch.int32, device=pcm.device),
        block_modes=modes,
        scale_factors=sf,
        word_lengths=wl,
        quantized=q,
    )
    return fd, new_state


def encode_frames(
    pcm, options: EncoderOptions | None = None, state: dict | None = None, device=None, plain: bool = False
) -> tuple[FrameData, dict]:
    """Public entry: encode [..., F, 512] f32 PCM (NumPy or tensor) on
    `device` (default: the card)."""
    dev = resolve_device(device)
    options = options or EncoderOptions()
    if not isinstance(pcm, torch.Tensor):
        pcm = torch.from_numpy(np.ascontiguousarray(pcm, dtype=np.float32))
    pcm = pcm.to(dev, torch.float32)
    if pcm.dim() < 2 or pcm.shape[-1] != C.SAMPLES_PER_FRAME:
        raise ValueError(f"encode_frames: need PCM [..., F, 512], got {tuple(pcm.shape)}")
    lead = pcm.shape[:-1]
    if state is None:
        state = encoder_init_state(dev, lead[0] if len(lead) > 1 else None)
    state = {k: v.to(dev) for k, v in state.items()}
    if lead[-1] == 0:
        z = lambda *tail: torch.zeros((*lead, *tail), dtype=torch.int32, device=dev)  # noqa: E731
        return FrameData(z(), z(3), z(C.NUM_BFUS), z(C.NUM_BFUS), z(C.NUM_BFUS, C.MAX_BFU_SIZE)), state
    return encode_step(pcm, state, options.band_thresholds, options.allocation_bias, options.allocator, plain=plain)
