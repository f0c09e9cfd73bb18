"""Frame sharding over a tuple of devices, the corpus transcoder and its
multi-process launcher (the counterpart of `carta1_tpu/parallel/`)."""

from carta1_tpu_torch.parallel.sharding import decode_frames_sharded, encode_frames_sharded, make_mesh

__all__ = ["encode_frames_sharded", "decode_frames_sharded", "make_mesh"]
