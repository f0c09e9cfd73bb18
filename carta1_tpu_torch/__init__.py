"""carta1_tpu_torch: the bit-exact ATRAC1 decode path in PyTorch and CUDA.

The port of `carta1_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.  It
imports neither JAX nor `carta1_tpu`; the JAX package is the reference it
is tested against.  Entry points run on the card unless the caller passes
`device="cpu"`, where each kernel's plain PyTorch version runs instead.

Exact arithmetic on every path: TF32 is off for matmul and cuDNN, nothing
is compiled with `torch.compile`, and no fused multiply-add touches a
value (see `kernels.py` for the CUDA side).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from carta1_tpu_torch.framedata import FrameData  # noqa: E402
from carta1_tpu_torch.pipeline.decoder import decode_frames, decode_step, decoder_init_state  # noqa: E402
from carta1_tpu_torch.processor import decode_units  # noqa: E402

__all__ = ["FrameData", "decode_frames", "decode_step", "decoder_init_state", "decode_units"]
