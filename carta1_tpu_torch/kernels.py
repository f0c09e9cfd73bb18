"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, loaded with `ctypes`.  The
build happens at first use, into `build/carta1_tpu_torch/` beside the
package, under a file name that carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.  A
failed build raises.

Arithmetic flags: `-fmad=false` keeps nvcc from contracting a multiply and
an add into one FMA, which would skip the product's rounding that the
reference performs; the sources also spell every f64 operation as an
explicit round-to-nearest intrinsic.  No fast-math flag is ever given.

Every kernel wrapper launches through `launch`, which puts the kernel on
its tensors' card whatever card is current, and calls `count(name)` once
per launch and nowhere else, so a run can show which kernels its main path
went through.
`time_ms` times calls on the device's clock for the scripts that measure.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "carta1_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

# kernel name -> (library, what it replaces in the JAX package: a Pallas
# kernel, for K4 the whole function that XLA compiled into one program, for
# K5 and K6 the exact engine's NumPy host code).  One library per source.
KERNELS = {
    "imdct_exact_64": ("imdct_exact", "carta1_tpu/ops/exact_fft_pallas.py:214"),
    "imdct_exact_256": ("imdct_exact", "carta1_tpu/ops/exact_fft_pallas.py:214"),
    "imdct_exact_512": ("imdct_exact", "carta1_tpu/ops/exact_fft_pallas.py:214"),
    "qmf_taps": ("qmf_taps", "carta1_tpu/ops/exact_qmf_pallas.py:79"),
    "read_fields": ("bitpack_read", "carta1_tpu/ops/bitpack_pallas.py:39"),
    "alloc_rdo": ("alloc_sweep", "carta1_tpu/ops/bitalloc.py:102"),
    "alloc_reference": ("alloc_sweep", "carta1_tpu/ops/bitalloc.py:187"),
    # the exact engine's kernels: the host code they replace has no Pallas kernel
    "alloc_heap": ("alloc_heap", "carta1_tpu/gold/coding.py:70"),
    "fft_js_mdct_64": ("fft_js", "carta1_tpu/gold/transforms.py:42"),
    "fft_js_mdct_256": ("fft_js", "carta1_tpu/gold/transforms.py:42"),
    "fft_js_mdct_512": ("fft_js", "carta1_tpu/gold/transforms.py:42"),
    "fft_js_spectrum_128": ("fft_js", "carta1_tpu/gold/fftjs.py:94"),
    "fft_js_spectrum_256": ("fft_js", "carta1_tpu/gold/fftjs.py:94"),
}
LIBRARIES = tuple(sorted({lib for lib, _ in KERNELS.values()}))

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOG: dict[str, str] = {}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _source_path(lib: str) -> Path:
    return CSRC / f"{lib}.cu"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME or PATH)")


def _lib_path(lib: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_source_path(lib).read_bytes())
    # every other file beside the sources may be included by one of them
    for header in sorted(f for f in CSRC.iterdir() if f.is_file() and f.suffix != ".cu"):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{lib}-{h.hexdigest()[:16]}.so"


def build(libs=LIBRARIES) -> float:
    """Compile the named libraries that are missing, all nvcc runs at once.

    Returns the wall seconds spent; raises RuntimeError on a failed build."""
    t0 = time.perf_counter()
    todo = [lib for lib in libs if not _lib_path(lib).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for lib in todo:
        tmp = _lib_path(lib).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(_source_path(lib))]
        procs[lib] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for lib, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[lib] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{lib}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, _lib_path(lib))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(lib: str) -> ctypes.CDLL:
    """The loaded library `lib`, built first if needed."""
    with _lock:
        if lib not in _loaded:
            build((lib,))
            cdll = ctypes.CDLL(str(_lib_path(lib)))
            cdll.carta1_error_string.argtypes = [ctypes.c_int]
            cdll.carta1_error_string.restype = ctypes.c_char_p
            _loaded[lib] = cdll
        return _loaded[lib]


def check(cdll: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {cdll.carta1_error_string(err).decode()}")


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that returns at once, through the same ctypes route
    as the real ones: what a launch alone costs on this machine."""
    cdll = library("qmf_taps")
    fn = cdll.carta1_empty_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    check(cdll, launch(fn, device), "empty_launch")


SPIN_CYCLES = 80_000_000     # torch.cuda._sleep: about 40 ms at the H100's 1.98 GHz


def time_ms(fn, reps: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) of one fn() call, means over reps calls.

    The calls are queued behind a spinning kernel of about 40 ms, so the
    device runs them back to back and the CUDA events around them read the
    device's time; a kernel of a few microseconds would otherwise be timed
    at the pace of the Python that launches it.  The host time is that
    pace: the wall time of one call that only enqueues."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host / reps * 1e3


def launch(fn, device: torch.device, *args) -> int:
    """Call the C launcher `fn(*args, stream)` on `device`'s current stream,
    with `device` made the current card for the call: the CUDA runtime in
    the library launches on the calling thread's current card, which need
    not be the card the tensors are on.  Returns the launcher's error code."""
    with torch.cuda.device(device):
        return fn(*args, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, align: int = 1) -> None:
    """Validate what a kernel takes: dtype, rank, contiguity, device type,
    and, on the card, the byte alignment of its first element (the kernels'
    vector copies need it)."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of rank {ndim}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name}: need data aligned to {align} bytes, got address {t.data_ptr():#x}")
