"""Temporal segment math: 1-D IoU, dense decode, pyramid location grids
(port of drn_tpu/ops/temporal.py)."""

from __future__ import annotations

from typing import Tuple

import torch


def temporal_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1-D IoU between (..., 2) segments with broadcastable leading dims;
    degenerate or empty segments give 0."""
    inter = (torch.minimum(a[..., 1], b[..., 1])
             - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0.0)
    len_a = (a[..., 1] - a[..., 0]).clamp_min(0.0)
    len_b = (b[..., 1] - b[..., 0]).clamp_min(0.0)
    union = len_a + len_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-8),
                       torch.zeros_like(union))


def pyramid_locations(base_len: int, num_levels: int,
                      device=None) -> Tuple[torch.Tensor, ...]:
    """Level l: base_len // 2**l cell centres (i + 0.5) * 2**l, in
    base-grid units."""
    return tuple(
        (torch.arange(base_len // 2 ** l, dtype=torch.float32, device=device)
         + 0.5) * float(2 ** l)
        for l in range(num_levels))


def decode_segments(locations: torch.Tensor, d_start: torch.Tensor,
                    d_end: torch.Tensor, max_len: float,
                    clip: bool = True) -> torch.Tensor:
    """segment = (loc - d_start, loc + d_end), (..., T, 2); clipped to
    [0, max_len] when `clip`, end never before start."""
    start = locations - d_start
    end = locations + d_end
    if clip:
        start = start.clamp(0.0, max_len)
        end = end.clamp(0.0, max_len)
    end = torch.maximum(end, start)
    return torch.stack([start, end], dim=-1)
