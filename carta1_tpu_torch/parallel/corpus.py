"""Corpus transcoding with checkpoint/resume and failure recovery.

The port of `carta1_tpu/parallel/corpus.py`: a corpus of WAV (or AEA)
files is striped across processes by rank, and each process runs its
files one after another through `encode_file` / `decode_file` on its card.
Transcoding is stateless above the file level, so recovery is
re-dispatch: a failed file is retried, a file that still fails has its
partial output removed, and a checkpoint records the finished inputs so
that a long job resumes where it stopped.  The checkpoint is the JAX
package's JSON file (`{"done": [...]}`, replaced atomically), so either
package resumes the other's run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Sequence

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.parallel.sharding import make_mesh
from carta1_tpu_torch.processor import DEFAULT_CHUNK_FRAMES, decode_file, encode_file


@dataclasses.dataclass
class CorpusResult:
    completed: list[str]
    failed: dict[str, str]          # input path -> error
    skipped: list[str]              # already done per checkpoint
    frames: int
    elapsed: float

    @property
    def realtime_multiple(self) -> float:
        audio_seconds = self.frames * C.SAMPLES_PER_FRAME / C.SAMPLE_RATE
        return audio_seconds / max(self.elapsed, 1e-9)


class Checkpoint:
    """Crash-safe progress record: one JSON file, atomically replaced."""

    def __init__(self, path: str | None):
        self.path = path
        self.done: set[str] = set()
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self.done = set(json.load(f).get("done", []))
            except (OSError, json.JSONDecodeError):
                self.done = set()

    def mark(self, key: str) -> None:
        self.done.add(key)
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"done": sorted(self.done)}, f)
            os.replace(tmp, self.path)


def _assigned(items: Sequence, process_index: int, process_count: int) -> list:
    return list(items[process_index::process_count])


def _rank_and_world() -> tuple[int, int]:
    """torch.distributed's rank and world size when a group is initialised, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def transcode_corpus(
    jobs: Sequence[tuple[str, str]],
    mode: str = "encode",
    options: EncoderOptions | None = None,
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    checkpoint_path: str | None = None,
    process_index: int | None = None,
    process_count: int | None = None,
    max_retries: int = 1,
    on_file_done: Callable[[str, int], None] | None = None,
    mesh="auto",
    device=None,
    engine: str = "tpu",
) -> CorpusResult:
    """Transcode a corpus of (input, output) jobs.

    mode: "encode" (WAV -> AEA) or "decode" (AEA -> WAV).  process_index and
    process_count default to torch.distributed's rank and world size when a
    process group is initialised (`parallel.multihost.initialize`), else 0
    and 1; process i takes jobs i, i + count, ...

    mesh: file striping (across processes) composes with frame sharding
    (across this process's cards).  "auto" means a mesh over every visible
    card when there is more than one and `device` is not given, else none;
    pass a mesh (`parallel.sharding.make_mesh`) or None.  `device` is the
    device of a run without a mesh (default: the card).

    engine: "tpu" or "exact" (`processor.encode_file`).  As in the JAX
    package, "auto" builds a mesh only for "tpu": a mesh run is the batched
    engine's.
    """
    if process_index is None or process_count is None:
        process_index, process_count = _rank_and_world()
    if mesh == "auto":
        mesh = make_mesh() if engine == "tpu" and device is None and torch.cuda.device_count() > 1 else None
    if mode not in ("encode", "decode"):
        raise ValueError(f"Unknown mode: {mode}")
    place = {"device": device} if mesh is None else {"mesh": mesh}

    ckpt = Checkpoint(checkpoint_path)
    completed: list[str] = []
    failed: dict[str, str] = {}
    skipped: list[str] = []
    frames = 0
    t0 = time.perf_counter()

    for input_path, output_path in _assigned(list(jobs), process_index, process_count):
        if input_path in ckpt.done and os.path.exists(output_path):
            skipped.append(input_path)
            continue
        last_err = None
        for _attempt in range(max_retries + 1):
            try:
                if mode == "encode":
                    result = encode_file(
                        input_path, output_path, options=options,
                        title=os.path.splitext(os.path.basename(output_path))[0],
                        chunk_frames=chunk_frames, engine=engine, **place,
                    )
                else:
                    result = decode_file(input_path, output_path, chunk_frames=chunk_frames, engine=engine, **place)
                frames += result.frames
                completed.append(input_path)
                ckpt.mark(input_path)
                if on_file_done:
                    on_file_done(input_path, result.frames)
                last_err = None
                break
            except Exception as e:  # noqa: BLE001 -- per-file isolation is the point
                last_err = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=3)}"
        if last_err is not None:
            failed[input_path] = last_err
            # a partial output from a failed attempt must not look complete
            if os.path.exists(output_path):
                try:
                    os.remove(output_path)
                except OSError:
                    pass

    return CorpusResult(
        completed=completed,
        failed=failed,
        skipped=skipped,
        frames=frames,
        elapsed=time.perf_counter() - t0,
    )
