"""The system under test: carta1_tpu_torch, as the benchmark drives it.

Every public entry of `carta1_tpu_torch.processor` (`encode_pcm`,
`encode_clips`, `encode_file`, `decode_units`, `decode_file`) runs one of
two functions per chunk of frames already on the device, carrying the
stream state from chunk to chunk:

  * `_encode_batch_dev(frames, options, state, engine=...)`: int16 frames
    [rows, F, 512] -> 212-byte units [rows, F, 212];
  * `_decode_batch_dev(units, state, to_i16=True)`: units -> int16 PCM
    [rows, F, 512].

A cell drives the entry its traffic names, a file of `benchmark/ops/`
(`spec.op`); those files, `benchmark/spans.py` (which reads the program's
`profiling.spans`) and this module are the benchmark's only modules that
import the package.  This one holds what the harness and the controls
share: the package's import, `EncoderOptions`, the kernels' build, the
units of whole tracks that a decode cell reads, and, for the decode
cells' control, the float32 decoder.
"""

from __future__ import annotations

import torch

from benchmark import spec


def load() -> None:
    """Import the package (its import turns TF32 off for the process)."""
    import carta1_tpu_torch  # noqa: F401


def options(config: dict):
    from carta1_tpu_torch.options import EncoderOptions

    return EncoderOptions(**config["options"])


def encode_track(config: dict, pcm: torch.Tensor, wrap=None) -> torch.Tensor:
    """The units of whole tracks, int16 [chunks, rows, F, 512] -> uint8
    [chunks, rows, F, 212], encoded by the configuration's engine with
    the state carried through the chunks: a decode cell's input, made at
    set-up.  `wrap(step)` may plant a fault in the encoder (`controls`)."""
    fn = spec.op("encode").step(config, (pcm.device,))
    if wrap is not None:
        fn = wrap(fn)
    state, out = None, []
    for chunk in pcm:
        units, state = fn(chunk, state)
        out.append(units)
    return torch.stack(out)


def build() -> float:
    """Build (or find in the checkout's build directory) every kernel
    library of the package; the seconds spent."""
    from carta1_tpu_torch import kernels

    return kernels.build()


def fast_decode_step():
    """The package's float32 decoder (within one int16 step of the exact
    one), in the chunk step's place: the decode comparison's control."""
    from carta1_tpu_torch.ops.bitpack import unpack_frames
    from carta1_tpu_torch.ops.pcm import float_to_int16
    from carta1_tpu_torch.pipeline.decoder import decode_step_fast, decoder_init_state

    def fn(chunk, state):
        if state is None:
            state = decoder_init_state(chunk.device, chunk.shape[0])
        pcm, state = decode_step_fast(unpack_frames(chunk), state)
        return float_to_int16(pcm), state
    return fn
