"""R@n, IoU@m recall counts on the device (port of drn_tpu/ops/metrics.py):
a hit at (n, m) iff any of the top-n NMS-surviving candidates has tIoU >= m
with the ground truth."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from drn_tpu_torch.ops.temporal import temporal_iou

# Counts-dict key of the summed top-1 tIoU (the mIoU accumulator).
MIOU_KEY = (0, -1.0)


def metric_name(key: Tuple) -> str:
    """(1, 0.5) → "R@1,IoU=0.5"; MIOU_KEY → "mIoU"."""
    if tuple(key) == MIOU_KEY:
        return "mIoU"
    n, m = key
    return f"R@{n},IoU={m:g}"


def recall_at_n(sorted_segments: torch.Tensor, keep: torch.Tensor,
                gt: torch.Tensor, ns: Sequence[int] = (1, 5),
                iou_thresholds: Sequence[float] = (0.3, 0.5, 0.7),
                valid: Optional[torch.Tensor] = None
                ) -> Dict[Tuple[int, float], torch.Tensor]:
    """Per-(n, m) hit counts summed over valid queries (fp32 scalars), plus
    the summed top-1 tIoU under MIOU_KEY. sorted_segments (B, K, 2) in NMS
    order, keep (B, K) bool, gt (B, 2), valid (B,) bool."""
    b, k, _ = sorted_segments.shape
    iou = temporal_iou(sorted_segments, gt[:, None, :])
    iou = torch.where(keep, iou, torch.zeros_like(iou))
    rank = torch.cumsum(keep.to(torch.int32), dim=1)
    rank = torch.where(keep, rank, torch.full_like(rank, k + 1))
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=gt.device)
    out: Dict[Tuple[int, float], torch.Tensor] = {}
    for n in ns:
        in_top_n = rank <= n
        for m in iou_thresholds:
            hit = (in_top_n & (iou >= m)).any(dim=1)
            out[(n, float(m))] = (hit & valid).sum().to(torch.float32)
    top1 = torch.where(rank == 1, iou, torch.zeros_like(iou)).sum(dim=1)
    out[MIOU_KEY] = torch.where(valid, top1,
                                torch.zeros_like(top1)).sum().to(torch.float32)
    return out
