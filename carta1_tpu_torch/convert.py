"""Moving stream state and frame data between NumPy and the port.

The JAX package and the gold engine keep the decoder state as a dict of
NumPy-convertible arrays (`tail0-2`, `synth_low/mid/high_delay`) and
frames as a NumPy `FrameData`; these helpers map both into torch and back,
so that either package can pick up a stream where the other left it.
"""

from __future__ import annotations

import numpy as np
import torch

from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.pipeline.decoder import STATE_KEYS


def framedata_from_numpy(fd, device=None) -> FrameData:
    """Any object with the five FrameData fields (NumPy or array-likes) ->
    torch FrameData of int32 tensors on `device`."""
    dev = resolve_device(device)
    return FrameData(*(
        torch.from_numpy(np.ascontiguousarray(np.asarray(getattr(fd, k)), dtype=np.int32)).to(dev)
        for k in FrameData.fields()
    ))


def state_from_numpy(state: dict, device=None) -> dict[str, torch.Tensor]:
    """Decoder state dict of arrays -> f32 tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(state[k], dtype=np.float32)).to(dev) for k in STATE_KEYS}


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """Decoder state dict of tensors -> f32 NumPy arrays on the host."""
    return {k: state[k].detach().cpu().numpy() for k in STATE_KEYS}
