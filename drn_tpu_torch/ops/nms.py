"""Batched greedy temporal NMS on the device (port of drn_tpu/ops/nms.py).

A K-step masked sweep over the (B, K, K) IoU matrix: candidate i, if still
kept, suppresses every lower-ranked candidate overlapping it above the
threshold. Ties in score keep their input order (stable sort), as
`jnp.argsort` does in the JAX package.
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.temporal import temporal_iou


def batched_temporal_nms(segments: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float):
    """segments (B, K, 2), scores (B, K) → (order, keep, sorted_segments):
    `order` (B, K) indices by score descending, `keep` (B, K) bool aligned
    with `order`, `sorted_segments` = segments[order]."""
    b, k = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    segs = torch.gather(segments, 1, order[..., None].expand(b, k, 2))
    over = temporal_iou(segs[:, :, None, :], segs[:, None, :, :]) \
        > iou_threshold                                    # (B, K, K)
    lower = torch.ones(k, k, dtype=torch.bool,
                       device=scores.device).triu(1)       # j > i
    over = over & lower
    keep = torch.ones((b, k), dtype=torch.bool, device=scores.device)
    for i in range(k):
        keep = keep & ~(over[:, i] & keep[:, i:i + 1])
    return order, keep, segs
