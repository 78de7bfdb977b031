"""Batched greedy temporal NMS on the device (port of drn_tpu/ops/nms.py).

Candidates are ranked by score, then swept in rank order: candidate i, if
still kept, suppresses every lower-ranked candidate overlapping it above
the threshold (`ops/cuda/nms_sweep.py`: one kernel launch on the card, the
plain K-step sweep on the CPU). Ties in score keep their input order
(stable sort), as `jnp.argsort` does in the JAX package.
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.cuda.nms_sweep import nms_sweep


def batched_temporal_nms(segments: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float):
    """segments (B, K, 2), scores (B, K) → (order, keep, sorted_segments):
    `order` (B, K) indices by score descending, `keep` (B, K) bool aligned
    with `order`, `sorted_segments` = segments[order]."""
    b, k = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    segs = torch.gather(segments, 1, order[..., None].expand(b, k, 2))
    return order, nms_sweep(segs, iou_threshold), segs
