"""The stage-1 training step in plain PyTorch, fp32: target assignment, the
losses, the gradient by autograd through reference/model.py, clipping by
the global norm and Adam, written from the method's definition.

  * positives: locations strictly inside the ground-truth span whose
    larger boundary distance (over the clip count) lies in the level's
    range; a query with none takes the level-0 location nearest the span's
    centre (the first on a tie);
  * regression: −log IoU of the unclipped decoded segment on positives;
  * matching: sigmoid focal loss (α, γ), over the valid rows;
  * IoU head: weighted squared error of sigmoid(iou_logit) against the IoU
    of the model's own segments, weight 1 on positives and 0.1 elsewhere,
    counted only from stage 2 on;
  * the gradient clipped to `grad_clip_norm` by its global norm, then
    Adam (0.9, 0.999, 1e-8, bias-corrected) at the piecewise-constant rate.

`tr` is the configuration file's `train` block. The LSTMs' `bias_hh_l0`
are constants of the model (one bias a gate) and are not trained.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from port_bench.reference import model as ref
from port_bench.reference.post import iou_1d

CONSTANT_SUFFIX = ".bias_hh_l0"
B1, B2, EPS = 0.9, 0.999, 1e-8


def positives(dims, gt):
    loc, lid = ref.locations(dims, gt.device)
    gs, ge = gt[:, 0:1], gt[:, 1:2]
    d_s, d_e = loc[None] - gs, ge - loc[None]
    max_d = torch.maximum(d_s, d_e) / float(dims["num_clips"])
    ranges = torch.tensor(dims["level_ranges"], dtype=torch.float32,
                          device=gt.device)
    pos = ((d_s > 0) & (d_e > 0) & (max_d >= ranges[lid, 0][None])
           & (max_d < ranges[lid, 1][None]))
    dist = torch.where(lid[None] == 0, (loc[None] - 0.5 * (gs + ge)).abs(),
                       torch.full_like(d_s, float("inf")))
    fallback = torch.zeros_like(pos)
    fallback[torch.arange(pos.shape[0], device=gt.device),
             dist.argmin(dim=1)] = True
    return torch.where(pos.any(dim=1, keepdim=True), pos, fallback)


def focal(logits, targets, alpha: float, gamma: float):
    ce = (logits.clamp_min(0.0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    if alpha < 0:
        return ce
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * (1 - p_t) ** gamma * ce


def loss(dims, tr, out, gt, valid) -> torch.Tensor:
    vrow = valid[:, None]
    pos = positives(dims, gt) & vrow
    posf = pos.float()
    num_pos = posf.sum().clamp_min(1.0)
    segs = ref.decode(dims, out["d_start"], out["d_end"], clip=False)
    iou = iou_1d(segs, gt[:, None, :]).clamp(1e-6, 1.0)
    reg = (-torch.log(iou) * posf).sum() / num_pos
    match = (focal(out["match_logits"], posf, tr["focal_alpha"],
                   tr["focal_gamma"]) * vrow).sum() / num_pos
    target = iou_1d(out["segments"], gt[:, None, :])
    w = torch.where(pos, 1.0, 0.1) * vrow
    iou_l = (w * (torch.sigmoid(out["iou_logits"]) - target) ** 2).sum() \
        / w.sum().clamp_min(1.0)
    return (tr["match_loss_weight"] * match + tr["reg_loss_weight"] * reg
            + float(tr["stage"] >= 2) * tr["iou_loss_weight"] * iou_l)


def learning_rate(tr, steps_per_epoch: int, count: int) -> float:
    lr = tr["learning_rate"]
    for e in tr["lr_decay_epochs"]:
        if count >= max(int(e * steps_per_epoch), 1):
            lr *= tr["lr_decay_rate"]
    return lr


def train_steps(p0: Dict[str, torch.Tensor], dims, tr, batches: List[dict],
                features: Callable[[dict], torch.Tensor],
                steps_per_epoch: int, q=ref.identity) -> dict:
    """len(batches) steps from the parameters p0 (left as they are) →
    {"losses": [each step's loss], "grad": {leaf: ‖g‖ of step 1's clipped
    gradient}, "change": {leaf:
    ‖p_end − p0‖}}."""
    if tr["stage"] != 1:
        raise NotImplementedError("the reference trains stage 1")
    p = {k: v.detach().clone().requires_grad_(not k.endswith(CONSTANT_SUFFIX))
         for k, v in p0.items()}
    trained = [k for k in p if p[k].requires_grad]
    mu = {k: torch.zeros_like(p[k]) for k in trained}
    nu = {k: torch.zeros_like(p[k]) for k in trained}
    out = {"losses": [], "grad": {}, "change": {}}
    for step, b in enumerate(batches, start=1):
        o = ref.forward(p, dims, features(b), b["word_ids"], b["query_mask"],
                        q)
        total = loss(dims, tr, o, b["gt_grid"], b["valid"])
        grads = torch.autograd.grad(total, [p[k] for k in trained],
                                    allow_unused=True)
        g = {k: (gi if gi is not None else torch.zeros_like(p[k])).detach()
             for k, gi in zip(trained, grads)}
        out["losses"].append(float(total.detach()))
        norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))
        clip = 1.0 if norm < tr["grad_clip_norm"] \
            else float(tr["grad_clip_norm"] / norm)
        lr = learning_rate(tr, steps_per_epoch, step - 1)
        with torch.no_grad():
            for k in trained:
                gk = g[k] * clip
                if step == 1:
                    out["grad"][k] = float(gk.norm())
                mu[k].mul_(B1).add_(gk, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(gk, gk, value=1 - B2)
                upd = (mu[k] / (1 - B1 ** step)) / (
                    (nu[k] / (1 - B2 ** step)).sqrt() + EPS)
                if tr["weight_decay"] > 0 and not k.startswith("embed."):
                    upd = upd + tr["weight_decay"] * p[k]
                p[k].sub_(lr * upd)
    with torch.no_grad():
        out["change"] = {k: float((p[k] - p0[k]).norm()) for k in trained}
    return out
