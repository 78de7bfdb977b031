"""Dense target assignment and training losses (port of
drn_tpu/models/losses.py), masked arithmetic over the flat (B, N) location
grid:

  * positives: locations strictly inside the GT span whose larger boundary
    distance falls in the level's range; a query with none gets the level-0
    location nearest the GT centre (the first such on a tie, as argmin);
  * regression: −log tIoU of the UNCLIPPED decoded segment, on positives;
  * matching: sigmoid focal loss (alpha < 0: plain BCE);
  * IoU head (stage 2): weighted MSE between sigmoid(iou_logit) and the tIoU
    of the model's own (gradient-stopped) segments.

`torch.maximum`/`torch.minimum` stand where the JAX package writes
`jnp.maximum`/`jnp.clip`: both split the gradient evenly at a tie.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from drn_tpu_torch.config import ModelConfig, TrainConfig
from drn_tpu_torch.ops.temporal import decode_segments, temporal_iou


def assign_targets(cfg: ModelConfig, locations: torch.Tensor,
                   level_ids: torch.Tensor, gt: torch.Tensor,
                   base_len: int) -> torch.Tensor:
    """locations, level_ids (N,); gt (B, 2) base-grid units → positives
    mask (B, N) bool."""
    gs, ge = gt[:, 0:1], gt[:, 1:2]
    d_s = locations[None, :] - gs
    d_e = ge - locations[None, :]
    inside = (d_s > 0) & (d_e > 0)
    max_d = torch.maximum(d_s, d_e) / float(base_len)
    ranges = torch.as_tensor(cfg.level_ranges, dtype=torch.float32,
                             device=gt.device)
    lo = ranges[level_ids, 0][None, :]
    hi = ranges[level_ids, 1][None, :]
    pos = inside & (max_d >= lo) & (max_d < hi)

    # Fallback: a GT shorter than one cell → the nearest level-0 location.
    has_pos = pos.any(dim=1, keepdim=True)
    center = 0.5 * (gs + ge)
    dist = (locations[None, :] - center).abs()
    dist = torch.where(level_ids[None, :] == 0, dist,
                       torch.full_like(dist, float("inf")))
    nearest = torch.argmin(dist, dim=1)  # first minimum, as jnp.argmin
    fallback = torch.zeros_like(pos)
    fallback[torch.arange(pos.shape[0], device=pos.device), nearest] = True
    return torch.where(has_pos, pos, fallback)


def focal_bce(logits: torch.Tensor, targets: torch.Tensor, alpha: float,
              gamma: float) -> torch.Tensor:
    """Per-element sigmoid focal loss; alpha < 0 → plain BCE."""
    p = torch.sigmoid(logits)
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    if alpha < 0:
        return ce
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def drn_loss(cfg: ModelConfig, tcfg: TrainConfig,
             outputs: Dict[str, torch.Tensor], locations: torch.Tensor,
             level_ids: torch.Tensor, gt: torch.Tensor, base_len: int,
             valid: Optional[torch.Tensor] = None,
             global_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]
             = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and per-term metrics (device tensors). `gt` (B, 2) in
    base-grid units; `valid` (B,) masks the padding rows of a ragged
    batch.

    `global_sum` sums a scalar over a data-parallel group (the identity by
    default). The normalisers, the count of positives and the IoU head's
    Σw, are then the global batch's, each clamped to ≥ 1 after the sum,
    as under the JAX package's SPMD step: the loss a rank returns is its
    rows' share, and Σ over the ranks of it (and of every metric but
    num_pos, which is global) is the global batch's."""
    if global_sum is None:
        global_sum = _identity
    b, _ = outputs["match_logits"].shape
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=gt.device)
    vrow = valid[:, None]

    pos = assign_targets(cfg, locations, level_ids, gt, base_len) & vrow
    posf = pos.float()
    num_pos = global_sum(posf.sum()).clamp_min(1.0)

    segs = decode_segments(locations, outputs["d_start"], outputs["d_end"],
                           float(base_len), clip=False)
    iou = temporal_iou(segs, gt[:, None, :])
    clipped = torch.minimum(torch.maximum(iou, torch.full_like(iou, 1e-6)),
                            torch.ones_like(iou))
    reg_loss = (-torch.log(clipped) * posf).sum() / num_pos

    m_loss = focal_bce(outputs["match_logits"], posf, tcfg.focal_alpha,
                       tcfg.focal_gamma)
    match_loss = (m_loss * vrow).sum() / num_pos

    iou_target = temporal_iou(outputs["segments"], gt[:, None, :])
    iou_pred = torch.sigmoid(outputs["iou_logits"])
    w = torch.where(pos, 1.0, 0.1) * vrow
    iou_loss = ((w * (iou_pred - iou_target) ** 2).sum()
                / global_sum(w.sum()).clamp_min(1.0))

    stage2 = float(tcfg.stage >= 2)
    total = (tcfg.match_loss_weight * match_loss
             + tcfg.reg_loss_weight * reg_loss
             + stage2 * tcfg.iou_loss_weight * iou_loss)
    metrics = {
        "loss": total,
        "match_loss": match_loss,
        "reg_loss": reg_loss,
        "iou_loss": iou_loss,
        "num_pos": num_pos,
        "mean_pos_iou": (iou * posf).sum() / num_pos,
    }
    return total, metrics
