"""Batched encoded-frame fields as torch tensors.

The same five int32 fields as `carta1_tpu/framedata.py`, dense [F, 52, 20]
slots with masks, without the JAX pytree registration.  A leading channel
axis ([C, F, ...]) is allowed: the decoder batches channels on it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FrameData:
    """n_bfu        : int32 [..., F]          number of active BFUs
    block_modes  : int32 [..., F, 3]       0 = long; 2 (bands 0/1) / 3 (band 2) = short
    scale_factors: int32 [..., F, 52]      scale factor indices
    word_lengths : int32 [..., F, 52]      word length indices
    quantized    : int32 [..., F, 52, 20]  quantized coefficients (padding slots 0)
    """

    n_bfu: torch.Tensor
    block_modes: torch.Tensor
    scale_factors: torch.Tensor
    word_lengths: torch.Tensor
    quantized: torch.Tensor

    @property
    def num_frames(self) -> int:
        return int(self.n_bfu.shape[-1])

    def __getitem__(self, sl) -> "FrameData":
        return FrameData(*(getattr(self, k)[sl] for k in self.fields()))

    def to(self, device) -> "FrameData":
        return FrameData(*(getattr(self, k).to(device) for k in self.fields()))

    @staticmethod
    def fields() -> tuple[str, ...]:
        return ("n_bfu", "block_modes", "scale_factors", "word_lengths", "quantized")
