"""Grading in plain PyTorch: score, the top-k by a stable sort, greedy
temporal NMS and the R@n, IoU≥m counts with the summed top-1 IoU.

Written from the method's definition, not from the program: score =
sigmoid(match) · sigmoid(iou)^w (w the configuration's rescore weight),
candidates ranked by score with ties to the lower location, the first
`top_k` kept; NMS walks them in rank order and drops each one that
overlaps a kept higher-ranked one by more than the threshold; a query hits
at (n, m) when one of its first n survivors has IoU ≥ m with the ground
truth. Counts are summed over the valid rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MIOU = "mIoU"


def iou_1d(a, b):
    """IoU of (..., 2) segments; 0 where the union is empty."""
    inter = (torch.minimum(a[..., 1], b[..., 1])
             - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0.0)
    union = ((a[..., 1] - a[..., 0]).clamp_min(0.0)
             + (b[..., 1] - b[..., 0]).clamp_min(0.0) - inter)
    return torch.where(union > 0, inter / union.clamp_min(1e-8),
                       torch.zeros_like(union))


def scores(ev: dict, match_logits, iou_logits):
    s = torch.sigmoid(match_logits)
    w = ev["score_iou_weight"]
    if ev["score_use_iou_head"] and w > 0.0:
        t = torch.sigmoid(iou_logits)
        s = s * (t ** w if w != 1.0 else t)
    return s


def grade(ev: dict, match_logits, iou_logits, segments, gt, valid
          ) -> Dict[str, float]:
    """Counts of one block of rows: {"R@n,IoU=m": hits, "mIoU": Σ top-1
    IoU} over the valid rows (floats)."""
    s = scores(ev, match_logits, iou_logits)
    ranked = torch.sort(s, dim=1, descending=True, stable=True)
    k = ev["top_k"]
    idx = ranked.indices[:, :k]
    segs = torch.gather(segments, 1, idx[..., None].expand(-1, -1, 2))
    over = iou_1d(segs[:, :, None, :], segs[:, None, :, :]) \
        > ev["nms_iou_threshold"]
    keep = torch.ones(segs.shape[:2], dtype=torch.bool, device=segs.device)
    for i in range(k):
        later = torch.arange(k, device=segs.device) > i
        keep = keep & ~(over[:, i] & later & keep[:, i:i + 1])
    hit_iou = torch.where(keep, iou_1d(segs, gt[:, None, :]),
                          torch.zeros(1, device=segs.device))
    rank = torch.where(keep, torch.cumsum(keep.long(), dim=1),
                       torch.full_like(keep, k + 1, dtype=torch.long))
    out: Dict[str, float] = {}
    for n in ev["recall_ns"]:
        for m in ev["iou_thresholds"]:
            hit = ((rank <= n) & (hit_iou >= m)).any(dim=1) & valid
            out[f"R@{n},IoU={m:g}"] = float(hit.sum())
    top1 = torch.where(rank == 1, hit_iou, torch.zeros_like(hit_iou)).sum(1)
    out[MIOU] = float(torch.where(valid, top1, torch.zeros_like(top1))
                      .double().sum())
    return out


def add(total: Dict[str, float], part: Dict[str, float]) -> Dict[str, float]:
    return {k: total.get(k, 0.0) + v for k, v in part.items()}


def percent(counts: Dict[str, float], n_valid: int) -> Dict[str, float]:
    return {k: 100.0 * v / max(n_valid, 1) for k, v in counts.items()}


def gap(a: Dict[str, float], b: Dict[str, float]) -> Tuple[float, str]:
    """The widest |a − b| over the metrics, and its metric; a metric one
    side lacks counts as an infinite gap."""
    worst, name = 0.0, ""
    for k in set(a) | set(b):
        g = abs(a[k] - b[k]) if k in a and k in b else float("inf")
        if g > worst or not name:
            worst, name = g, k
    return worst, name
