"""The exact engine (`engine="exact"`): the port of `carta1_tpu/gold/`.

Its encoder's units are byte-equal to the reference JavaScript's (and to
`tests/fixtures/golden.aea`), its decoder's PCM bit-identical: f64
compute with an f32 store at each store of the reference, in PyTorch ops
that round once each and in two hand kernels, K5 (the reference's
max-heap allocator, `ops/heap_kernels.py`) and K6 (the fft.js forward
transforms, `ops/fftjs_kernels.py`).  It runs on the card unless the
caller asks for the CPU, where the kernels' plain versions run instead.
"""

from carta1_tpu_torch.gold.encoder import encoder_init_state, gold_encode_frames
from carta1_tpu_torch.gold.decoder import decoder_init_state, gold_decode_frames

__all__ = [
    "encoder_init_state",
    "gold_encode_frames",
    "decoder_init_state",
    "gold_decode_frames",
]
