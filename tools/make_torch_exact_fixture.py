#!/usr/bin/env python3
"""Write tests/fixtures/torch_exact_expect.npz: input frames and the gold
engine's sound units, for the PyTorch port's exact engine on a machine that
has neither JAX nor the JAX package (chip_smoke.py phase 11).

Stored: the golden signal of tests/test_golden.py (87 frames) and its units
(those of tests/fixtures/golden.aea); the first 32 frames of each of the six
signal classes (`carta1_tpu_torch.testing.signals(1.0)`) and their units at
allocation bias 1.0; two of the classes also at 0.7 and 2.0.  The inputs are
stored as f32 because the signals go through NumPy's sin, whose last bits
may differ on another machine.  Reading: `carta1_tpu_torch.testing.exact_expect`.

Run from the repository root:  python tools/make_torch_exact_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> None:
    os.environ.setdefault("CARTA1_NO_NATIVE", "1")
    from carta1_tpu.gold import gold_encode_frames
    from carta1_tpu.io.bitstream_np import pack_frames
    from carta1_tpu.options import EncoderOptions
    from carta1_tpu_torch import testing
    from test_golden import _golden_signal

    out = {}
    inputs = {"golden": _golden_signal()}
    for name, sig in testing.signals(1.0).items():
        frames = np.zeros((testing.EXACT_CLASS_FRAMES * 512,), np.float32)
        frames[:] = sig[: frames.size]
        inputs[name] = frames.reshape(-1, 512)
    for name, frames in inputs.items():
        out[f"{name}/frames"] = frames
        biases = (1.0,) + (testing.EXACT_BIASES if name in testing.EXACT_BIAS_CLASSES else ())
        for bias in biases:
            fd, _ = gold_encode_frames(frames, EncoderOptions(allocation_bias=bias))
            out[f"{name}/units_{bias}"] = pack_frames(fd)
            print(name, bias, frames.shape[0], "frames; short frames per band",
                  (fd.block_modes != 0).sum(axis=0).tolist())
    path = os.path.join(ROOT, "tests", "fixtures", "torch_exact_expect.npz")
    np.savez_compressed(path, **out)
    print("wrote", path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
