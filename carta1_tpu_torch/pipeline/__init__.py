"""Batched encoder and decoder pipelines (frames are the batch axis)."""

from carta1_tpu_torch.pipeline.encoder import encode_frames, encoder_init_state
from carta1_tpu_torch.pipeline.decoder import decode_frames, decoder_init_state

__all__ = [
    "encode_frames",
    "encoder_init_state",
    "decode_frames",
    "decoder_init_state",
]
