"""carta1_tpu_torch: the ATRAC1 codec (encode and bit-exact decode) in PyTorch and CUDA.

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
from carta1_tpu_torch.options import EncoderOptions  # noqa: E402
from carta1_tpu_torch.pipeline.decoder import decode_frames, decode_step, decoder_init_state  # noqa: E402
from carta1_tpu_torch.pipeline.encoder import encode_frames, encode_step, encoder_init_state  # noqa: E402
from carta1_tpu_torch.processor import decode_file, decode_units, encode_clips, encode_file, encode_pcm  # noqa: E402
from carta1_tpu_torch.ops.bitpack import pack_frames, unpack_frames  # noqa: E402
from carta1_tpu_torch.gold import gold_decode_frames, gold_encode_frames  # noqa: E402
from carta1_tpu_torch.parallel import decode_frames_sharded, encode_frames_sharded, make_mesh  # noqa: E402
from carta1_tpu_torch.parallel.corpus import transcode_corpus  # noqa: E402

__all__ = [
    "EncoderOptions", "FrameData",
    "decode_file", "decode_frames", "decode_step", "decoder_init_state", "decode_units",
    "encode_clips", "encode_file", "encode_frames", "encode_step", "encoder_init_state", "encode_pcm",
    "decode_frames_sharded", "encode_frames_sharded", "make_mesh", "transcode_corpus",
    "gold_decode_frames", "gold_encode_frames", "pack_frames", "unpack_frames",
]
