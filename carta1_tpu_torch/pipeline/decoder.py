"""Batched decoder pipeline.

FrameData -> [..., F, 512] PCM: dequantize -> scatter -> per-band IMDCT
with a 16-sample tail halo -> high-band delay -> two QMF merges.  Two paths
share the structure, as in `carta1_tpu/pipeline/decoder.py`:

  * decode_step      -- the default: bit-identical to
    `carta1_tpu/gold/decoder.py` (and so to the reference JavaScript and to
    the JAX `decode_step`), f64 with an f32 store at each reference store,
    on kernels K1 (IMDCT) and K2 (QMF taps).
  * decode_step_fast -- plain f32 basis products and convolutions
    (`torch.matmul`, `conv1d`, no hand kernel), within one int16 step of
    the reference; the JAX `decode_step_fast`.

Reference pipeline: codec/pipeline/decoder.js:408-411.  A leading channel
axis on the fields and the state batches channels.
"""

from __future__ import annotations

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import profiling
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.ops import exact_decode as X
from carta1_tpu_torch.ops.coding import dequantize, scatter_bfus
from carta1_tpu_torch.ops.mdct import decoder_imdct_band
from carta1_tpu_torch.ops.qmf import delay_stream, qmf_synthesis

STATE_KEYS = ("tail0", "tail1", "tail2", "synth_low_delay", "synth_mid_delay", "synth_high_delay")


def decoder_init_state(device=None, channels: int | None = None) -> dict[str, torch.Tensor]:
    """Zero stream state (same keys and shapes as gold.decoder_init_state),
    with a leading [channels] axis when `channels` is given."""
    dev = resolve_device(device)
    lead = () if channels is None else (channels,)
    sizes = (C.MDCT_TAIL_WINDOW_SIZE,) * 3 + (C.QMF_DELAY, C.QMF_DELAY, C.QMF_HIGH_BAND_DELAY)
    return {k: torch.zeros(lead + (n,), dtype=torch.float32, device=dev) for k, n in zip(STATE_KEYS, sizes)}


def decode_step(fd: FrameData, state: dict, plain: bool = False) -> tuple[torch.Tensor, dict]:
    """Bit-exact batched decode: FrameData -> (pcm [..., F, 512], state).

    `plain=True` runs the kernels' plain PyTorch versions on any device."""
    with profiling.span("carta1.decode.dequantize"):
        deq = X.dequantize_exact(fd.quantized, fd.scale_factors, fd.word_lengths)
        coeffs = scatter_bfus(deq, fd.block_modes, fd.n_bfu)          # [..., F, 512]

    with profiling.span("carta1.decode.imdct"):
        outs, new_tails = X.imdct_bands_exact(
            coeffs, fd.block_modes, (state["tail0"], state["tail1"], state["tail2"]), plain=plain
        )

    with profiling.span("carta1.decode.synthesis"):
        high_delayed, high_d = delay_stream(outs[2], state["synth_high_delay"])
        stage2, mid_d = X.qmf_synthesis_exact(outs[0], outs[1], state["synth_mid_delay"], plain=plain)
        pcm, low_d = X.qmf_synthesis_exact(stage2, high_delayed, state["synth_low_delay"], plain=plain)

    return pcm, _state(new_tails, low_d, mid_d, high_d)


def decode_step_fast(fd: FrameData, state: dict) -> tuple[torch.Tensor, dict]:
    """Fast batched decode in f32 (one int16 step of the reference at most):
    FrameData -> (pcm [..., F, 512], state)."""
    deq = dequantize(fd.quantized, fd.scale_factors, fd.word_lengths)
    coeffs = scatter_bfus(deq, fd.block_modes, fd.n_bfu)              # [..., F, 512]

    outs, new_tails, offset = [], [], 0
    for b, size in enumerate(C.MDCT_BAND_SIZES):
        out, tail = decoder_imdct_band(coeffs[..., offset:offset + size], b, fd.block_modes[..., b], state[f"tail{b}"])
        outs.append(out)
        new_tails.append(tail)
        offset += size

    high_delayed, high_d = delay_stream(outs[2], state["synth_high_delay"])
    stage2, mid_d = qmf_synthesis(outs[0], outs[1], state["synth_mid_delay"])
    pcm, low_d = qmf_synthesis(stage2, high_delayed, state["synth_low_delay"])
    return pcm, _state(new_tails, low_d, mid_d, high_d)


def _state(tails: list, low_d: torch.Tensor, mid_d: torch.Tensor, high_d: torch.Tensor) -> dict:
    return dict(zip(STATE_KEYS, (*tails, low_d, mid_d, high_d)))


def decode_frames(
    fd: FrameData, state: dict | None = None, fast: bool = False, *, device=None, plain: bool = False
) -> tuple[torch.Tensor, dict]:
    """Public entry: decode FrameData on `device` (default: the card);
    `fast=True` takes `decode_step_fast`."""
    dev = resolve_device(device)
    fd = fd.to(dev)
    if state is None:
        lead = fd.n_bfu.shape[:-1]
        state = decoder_init_state(dev, lead[0] if lead else None)
    state = {k: v.to(dev) for k, v in state.items()}
    if fd.num_frames == 0:
        return torch.zeros((*fd.n_bfu.shape, C.SAMPLES_PER_FRAME), device=dev), state
    if fast:
        return decode_step_fast(fd, state)
    return decode_step(fd, state, plain=plain)
