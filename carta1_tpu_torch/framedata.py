"""Batched encoded-frame fields as torch tensors.

The same five int32 fields as `carta1_tpu/framedata.py`, dense [F, 52, 20]
slots with masks, without the JAX pytree registration.  A leading channel
axis ([C, F, ...]) is allowed: the decoder batches channels on it.
`to_numpy` gives the same class holding int32 NumPy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from carta1_tpu_torch.constants import MAX_BFU_SIZE, NUM_BFUS
from carta1_tpu_torch.device import resolve_device

# each field's frame axis, counted from the end ([..., F] up to [..., F, 52, 20])
_FRAME_AXIS = {"n_bfu": -1, "block_modes": -2, "scale_factors": -2, "word_lengths": -2, "quantized": -3}


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

    def to_numpy(self) -> "FrameData":
        """The fields as int32 NumPy arrays on the host."""
        return FrameData(*(torch.as_tensor(getattr(self, k)).detach().cpu().numpy().astype(np.int32, copy=False)
                           for k in self.fields()))

    @staticmethod
    def zeros(num_frames: int, *, device=None) -> "FrameData":
        """Silent frames (n_bfu = 0, the reference's dummy frame,
        processor.js:278-286), int32 [F], [F, 3], [F, 52], [F, 52],
        [F, 52, 20] on `device` (default the card; raises without one)."""
        dev = resolve_device(device)

        def z(*shape: int) -> torch.Tensor:
            return torch.zeros((num_frames, *shape), dtype=torch.int32, device=dev)

        return FrameData(z(), z(3), z(NUM_BFUS), z(NUM_BFUS), z(NUM_BFUS, MAX_BFU_SIZE))

    @staticmethod
    def fields() -> tuple[str, ...]:
        return ("n_bfu", "block_modes", "scale_factors", "word_lengths", "quantized")

    @staticmethod
    def concatenate(parts: list["FrameData"]) -> "FrameData":
        """The parts joined along the frame axis ([F, ...] or [C, F, ...])."""
        return FrameData(*(torch.cat([getattr(p, k) for p in parts], dim=_FRAME_AXIS[k]) for k in FrameData.fields()))
