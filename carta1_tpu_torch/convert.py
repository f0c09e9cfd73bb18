"""Moving stream state and frame data between NumPy and the port.

The JAX package and the gold engine keep a stream's state as a dict of
NumPy-convertible arrays (decoder: `tail0-2`, `synth_low/mid/high_delay`;
encoder: `qmf_*_delay`, `prev_spectrum0-2`, `band_tail0-2`) and frames as
a NumPy `FrameData`; these helpers map both into torch and back, so that
either package can pick up a stream where the other left it.  The encoder
has no weights: state, tables and `FrameData` are all that crosses.
"""

from __future__ import annotations

import numpy as np
import torch

from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData


def framedata_from_numpy(fd, device=None) -> FrameData:
    """Any object with the five FrameData fields (NumPy or array-likes) ->
    torch FrameData of int32 tensors on `device`."""
    dev = resolve_device(device)
    return FrameData(*(
        torch.from_numpy(np.ascontiguousarray(np.asarray(getattr(fd, k)), dtype=np.int32)).to(dev)
        for k in FrameData.fields()
    ))


def state_from_numpy(state: dict, device=None) -> dict[str, torch.Tensor]:
    """Encoder or decoder state dict of arrays -> f32 tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev) for k, v in state.items()}


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """Encoder or decoder state dict of tensors -> f32 NumPy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def framedata_to_numpy(fd: FrameData) -> dict[str, np.ndarray]:
    """torch FrameData -> {field: int32 NumPy array}: the keyword arguments
    of the JAX package's `FrameData`."""
    host = fd.to_numpy()
    return {k: getattr(host, k) for k in FrameData.fields()}
