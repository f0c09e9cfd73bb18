"""Tracing, stage spans, NaN checks and stream statistics (the counterpart of
`carta1_tpu/profiling.py`).

  * `trace(dir)`  -- `torch.profiler` over the enclosed region, CPU and, on
    the card, CUDA activity; writes a Chrome trace into `dir`.
  * `span(name, like)` -- a stage of the chunk step, recorded only while a
    `torch.profiler` records (`trace` above, or any other): a host range
    in the profiler's own trace, on the clock of its device events; CUDA
    timing events on the step's stream at entry and exit; and a record
    kept in memory (the newest `SPAN_BUFFER`).  Off, it is one flag test.
  * `spans()` -- those records, each with its host and device
    milliseconds and its counts; the caller synchronises first.
  * `enable_nan_debugging()` -- while on, the processor's chunk steps check
    the f32 tensors they make (the encoder's input PCM and analysis spectra,
    the decoder's PCM) and raise `FloatingPointError` naming the stage.  Off
    by default: every check waits for the device.
  * `stream_stats(fd)` -- frame statistics (bits per frame, block-mode
    rates) of a `FrameData` on any device.

The spans of one chunk step (`processor._encode_batch_dev` /
`_decode_batch_dev`) form a tree under `carta1.encode.step` or
`carta1.decode.step`, whose leaves are the codec's stages:

    carta1.encode.step
        carta1.encode.analysis
            carta1.encode.qmf  .transient  .mdct  .scale_factors
        carta1.encode.allocate  carta1.encode.quantize  carta1.encode.pack
    carta1.decode.step
        carta1.decode.unpack  carta1.decode.dequantize
        carta1.decode.imdct
            carta1.decode.short_index (the host's wait for the short frames'
                                       index; counts `short_band_frames`)
        carta1.decode.synthesis

Every launch of a step falls in one leaf, but for the conversions at the
step's ends (int16 -> f32 and a new zero state at entry, f32 -> int16 at
exit).  A span's host range is a function-scope record
(`_RecordFunctionFast`), which the profiler keeps on the host alone: a
user-scope `record_function` range would also get a device-side copy,
which a reader of the trace would count as device work.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData

TRACE_FILE = "trace.json"
SPAN_BUFFER = 4096            # span records kept, the newest (a chunk step opens 6 to 9)
_NAN_CHECKS = False
_SPANS: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_OPEN = threading.local()     # this thread's open spans, innermost last
_IDS = itertools.count()


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


class _Off:
    """The span of a step that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, key: str, n: int) -> None:
        return None


_OFF = _Off()


class _Span:
    """One open or closed span and its record (`span`)."""

    __slots__ = ("id", "name", "parent", "call", "device", "t0_ns", "t1_ns", "events", "counts", "_range")

    def __init__(self, name: str, like: torch.Tensor | None):
        open_ = _open_spans()
        up = open_[-1] if open_ else None
        self.id = next(_IDS)
        self.name = name
        self.parent = up.id if up else None
        self.call = up.call if up else self.id
        if like is not None:
            self.device = like.device if like.device.type == "cuda" else None
        else:
            self.device = up.device if up else None
        self.t0_ns = self.t1_ns = None
        self.events = None
        self.counts = {}

    def __enter__(self):
        _open_spans().append(self)
        _SPANS.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self._range.__exit__(*exc)
        _open_spans().pop()

    def add(self, key: str, n: int) -> None:
        """Add `n` to this span's count `key`."""
        self.counts[key] = self.counts.get(key, 0) + n


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def span(name: str, like: torch.Tensor | None = None):
    """A context for one stage of a chunk step, named `name`
    ("carta1.<op>.<stage>"); `with span(...) as s:` gives `s.add(key, n)`
    for the stage's counts.

    While no `torch.profiler` records, this is one test of torch's flag
    for that and one shared context that does nothing.  While one
    records, the span opens a host range of its name in the profiler's
    trace, records a CUDA timing event on the current stream of the
    step's device at entry and at exit (it never synchronises), and keeps
    a record (`spans`).  The step's device is that of the tensor `like`
    (a step's span passes its input), else the enclosing span's; a step
    on the CPU records no events."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, like)


def spans() -> list[dict]:
    """The newest `SPAN_BUFFER` span records, oldest first: `id`, `name`,
    `parent` (its id, None at a step), `call` (the id of the step span it
    belongs to), `host_ms` (perf_counter from entry to exit), `device_ms`
    (from the entry event to the exit event on the step's stream: None for
    a step on the CPU or an exit event the device has not reached; the
    caller synchronises, this does not) and `counts`.  A span still open
    has `host_ms` and `device_ms` None."""
    out = []
    for s in list(_SPANS):
        done = s.t1_ns is not None
        device_ms = None
        if done and s.events is not None and s.events[1].query():
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"id": s.id, "name": s.name, "parent": s.parent, "call": s.call,
                    "host_ms": (s.t1_ns - s.t0_ns) / 1e6 if done else None, "device_ms": device_ms,
                    "counts": dict(s.counts)})
    return out


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
