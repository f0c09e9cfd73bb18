#!/usr/bin/env python3
"""Write tests/fixtures/torch_encode_expect.npz: what the gold engine makes
of the six encode-quality signal classes, for the PyTorch port's checks on
a machine that has neither JAX nor the JAX package.

For each class of `quality_report.signals(1.0)` (1 s, 87 frames): the gold
encoder's block modes and scale factors, its round-trip PSNR through the
bitstream and the gold decoder, and, for the record, the JAX encoder on the
CPU: its PSNR through the same decoder, and its scale factors with the
reference allocator (an f32-MDCT encoder lands a few BFU peaks on the other
side of a scale-factor table value than the gold engine's FFT does).

Run from the repository root:  python tools/make_torch_encode_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SECONDS = 1.0


def main() -> None:
    # no FMA contraction on x86 (as the test suite pins it), before JAX starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from carta1_tpu.gold import gold_decode_frames, gold_encode_frames
    from carta1_tpu.io.bitstream_np import pack_frames_fast, unpack_frames_fast
    from carta1_tpu.options import EncoderOptions
    from carta1_tpu.pipeline import encode_frames
    from carta1_tpu.processor import pcm_to_frames
    from quality_report import psnr, signals

    out = {"seconds": np.float64(SECONDS)}
    for name, sig in signals(SECONDS).items():
        frames = pcm_to_frames(sig)
        fd_gold, _ = gold_encode_frames(frames)
        fd_jax, _ = encode_frames(frames)
        fd_jax_ref, _ = encode_frames(frames, EncoderOptions(allocator="reference"))
        sf_jax = np.asarray(fd_jax_ref.scale_factors)
        if not np.array_equal(np.asarray(fd_jax_ref.block_modes), fd_gold.block_modes):
            raise AssertionError(f"{name}: the JAX encoder's block modes differ from the gold engine's")
        pcm_gold, _ = gold_decode_frames(unpack_frames_fast(pack_frames_fast(fd_gold)))
        pcm_jax, _ = gold_decode_frames(unpack_frames_fast(pack_frames_fast(fd_jax.to_numpy())))
        out[f"{name}/block_modes"] = fd_gold.block_modes.astype(np.int8)
        out[f"{name}/scale_factors"] = fd_gold.scale_factors.astype(np.int8)
        out[f"{name}/scale_factors_jax_cpu"] = sf_jax.astype(np.int8)
        out[f"{name}/psnr_gold"] = np.float64(psnr(sig, pcm_gold.reshape(-1)))
        out[f"{name}/psnr_jax_cpu"] = np.float64(psnr(sig, np.asarray(pcm_jax).reshape(-1)))
        print(name, frames.shape[0], "frames; short frames per band",
              (fd_gold.block_modes != 0).sum(axis=0).tolist(),
              "scale factors where JAX differs from gold", int((sf_jax != fd_gold.scale_factors).sum()),
              "psnr gold %.3f jax-cpu %.3f" % (out[f"{name}/psnr_gold"], out[f"{name}/psnr_jax_cpu"]))
    path = os.path.join(ROOT, "tests", "fixtures", "torch_encode_expect.npz")
    np.savez_compressed(path, **out)
    print("wrote", path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
