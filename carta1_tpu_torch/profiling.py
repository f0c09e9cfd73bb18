"""Tracing, NaN checks and stream statistics (the counterpart of
`carta1_tpu/profiling.py`).

  * `trace(dir)`  -- `torch.profiler` over the enclosed region, CPU and, on
    the card, CUDA activity; writes a Chrome trace into `dir`.
  * `enable_nan_debugging()` -- while on, the processor's chunk steps check
    the f32 tensors they make (the encoder's input PCM and analysis spectra,
    the decoder's PCM) and raise `FloatingPointError` naming the stage.  Off
    by default: every check waits for the device.
  * `stream_stats(fd)` -- frame statistics (bits per frame, block-mode
    rates) of a `FrameData` on any device.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData

TRACE_FILE = "trace.json"
_NAN_CHECKS = False


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed region on `device` (default: the card) and write
    `log_dir/trace.json` (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def enable_nan_debugging(enabled: bool = True) -> None:
    global _NAN_CHECKS
    _NAN_CHECKS = enabled


def nan_check(stage: str, x: torch.Tensor) -> None:
    """Raise FloatingPointError if NaN debugging is on and `x` holds a NaN."""
    if _NAN_CHECKS and bool(torch.isnan(x).any()):
        raise FloatingPointError(f"NaN in {stage} (shape {tuple(x.shape)})")


def stream_stats(fd: FrameData) -> dict:
    """Structured observability metrics for a batch of frames [F, ...]."""
    wl = fd.word_lengths.cpu().numpy()
    sf = fd.scale_factors.cpu().numpy()
    modes = fd.block_modes.cpu().numpy()
    nf = fd.num_frames
    wl_bits = np.where(wl > 0, wl + 1, 0)
    bits_per_frame = (wl_bits * C.SPECS_PER_BFU[None, :]).sum(axis=1)
    short_any = (modes != 0).any(axis=1)
    hist, edges = np.histogram(bits_per_frame, bins=[0, 1, 256, 512, 768, 1024, 1137])
    return {
        "frames": int(nf),
        "bitsPerFrame": {
            "mean": float(bits_per_frame.mean()) if nf else 0.0,
            "min": int(bits_per_frame.min()) if nf else 0,
            "max": int(bits_per_frame.max()) if nf else 0,
            "histogram": {f"[{int(a)},{int(b)})": int(n) for a, b, n in zip(edges[:-1], edges[1:], hist)},
        },
        "blockModes": {
            "shortFrameRate": float(short_any.mean()) if nf else 0.0,
            "perBandShortRate": [float((modes[:, b] != 0).mean()) if nf else 0.0 for b in range(3)],
        },
        "silentFrames": int(((wl == 0).all(axis=1) & (sf == 0).all(axis=1)).sum()),
    }
