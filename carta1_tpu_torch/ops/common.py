"""Shared batched-op helpers (frames on axis -2, any leading batch axes)."""

from __future__ import annotations

import torch


def halo_prefix(x: torch.Tensor, stream_prefix: torch.Tensor) -> torch.Tensor:
    """Prepend each frame with the last P samples of the previous frame.

    x: [..., F, L]; stream_prefix: [..., P] carry for frame 0 (the stream
    state).  Returns [..., F, P + L].  This is how every inter-frame delay
    line of the reference (codec/core/buffers.js:31-42) becomes a batched
    halo."""
    p = stream_prefix.shape[-1]
    prev = torch.cat([stream_prefix.unsqueeze(-2), x[..., :-1, -p:]], dim=-2)
    return torch.cat([prev, x], dim=-1)


def shift_frames(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """[..., F, K] -> each frame's previous row, with `first` [..., K] for frame 0."""
    return torch.cat([first.unsqueeze(-2), x[..., :-1, :]], dim=-2)
