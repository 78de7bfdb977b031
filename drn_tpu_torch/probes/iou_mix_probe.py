"""The IoU head's first mix folded through its sampling, or not (port of
scripts/iou_mix_probe.py).

    python -m drn_tpu_torch.probes.iou_mix_probe [--config tacos_c3d]
    python -m drn_tpu_torch.probes.iou_mix_probe --device cpu \\
        --config synthetic_tiny --iters 1                     # a rehearsal

Sampling and the first k=1 mix are both linear, so

    mix_0(concat_k(Sel_k · F))  ==  Σ_k Sel_k · (F · W0_k) + b0

and the (B, N, 3D) sampled intermediate need never exist. At `--config`'s
eval shapes (tacos_c3d: B=32, T=512, 4 levels, N=960 locations, D=512)
with seeded random weights and the script's inputs from seed 0 (bf16
pyramid levels, sorted uniform segments), two variants:

  - **A**: the port's `IoUHead` (`models/heads.py`): each level gathered
    at start / mid / end, concatenated to (B, N, 3D), then every mix
    (`conv_ln_relu`). The port never folds (its config does not read
    `iou_fold_mix_min_locations`). In the JAX package the script's "A:
    current IoUHead" is not this: at tacos_c3d N=960 is above the JAX
    config's `iou_fold_mix_min_locations=512`, so the JAX IoUHead already
    folds there and the script's A and B run one formulation.
  - **B**: `folded_iou_head`, the JAX IoUHead's folded branch: per level
    and per kind k, F_l · W0_k (three (B, T_l, D) products, the tap width
    taken from mix_0's weight), each sampled at its positions and summed,
    + b0, mix_0's LayerNorm (fp32) and ReLU, then the remaining mixes and
    the output conv as in A.

Rows (`bench.call_row`): the host clock's time a call of a chain of
`--iters` calls through the pyramid, with `clamped`; the device time a
call from a profiler trace (summed and union) and the kernels a call; and
on B's row `rel_diff`, max |A − B| over max |A|, which the bf16 order of
the sums bounds (`AB_REL_TOL`). This probe only measures: the port's
IoUHead does not take the fold. One JSON line a row on stdout. Runs on
`cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import torch

# A against B in bf16: the same products summed in another order, rounded
# to bf16 at other points (the three (B, T_l, D) projections before the
# sampling, the (B, N, 3D) samples before the mix), then ~3 layers of
# LayerNorm; the script's "bf16 order tolerance ~1e-2", doubled.
AB_REL_TOL = 2e-2


def folded_iou_head(head, pyramid: List[torch.Tensor],
                    segments: torch.Tensor, level_ids: torch.Tensor,
                    strides: torch.Tensor) -> torch.Tensor:
    """`head`'s (an `IoUHead`) output with mix_0 folded through the
    sampling, as the JAX IoUHead computes it above its fold threshold:
    (B, N) fp32."""
    from drn_tpu_torch.models.heads import level_positions, segment_positions
    from drn_tpu_torch.models.layers import (cdt, layer_norm,
                                             linear_time_sample)

    dt = cdt(head.cfg)
    mix0 = head.iou_mix[0]
    w0 = mix0.conv.weight[:, :, 0].t().to(dt)              # (3D, D)
    # The tap width from the weight itself, as the JAX IoUHead asserts.
    d = w0.shape[0] // 3
    if w0.shape[0] != 3 * pyramid[0].shape[-1]:
        raise ValueError(f"mix_0 takes {w0.shape[0]} channels, not 3 x "
                         f"{pyramid[0].shape[-1]}")
    sizes = [p.shape[1] for p in pyramid]
    per_level = level_positions(sizes, segment_positions(
        sizes, segments, level_ids, strides))
    parts = []
    for p_l, qs in zip(pyramid, per_level):
        x_l = p_l.to(dt)
        parts.append(sum(linear_time_sample(x_l @ w0[k * d:(k + 1) * d], q)
                         for k, q in enumerate(qs)))         # (B, T_l, D)
    x = torch.cat(parts, dim=1) + mix0.conv.bias.float()
    x = torch.relu(layer_norm(x, mix0.norm.weight, mix0.norm.bias).to(dt))
    return head.mix(x, 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the IoU head's first mix, "
                                            "folded or not")
    p.add_argument("--config", default="tacos_c3d")
    p.add_argument("--iters", type=int, default=32,
                   help="chained calls per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import call_row, print_row
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.models.drn import location_metadata
    from drn_tpu_torch.probes.profile_residual import make_inputs

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    levels, _, segments = make_inputs(cfg, dev, queries=False)
    _, strides, level_ids = location_metadata(cfg.model, cfg.data.num_clips,
                                              dev)
    head = build_model(cfg, device=dev, seed=0).iou_head
    variants = {
        "A": ("the port's IoUHead: per-level gather, no fold",
              lambda lv: head(lv, segments, level_ids, strides)),
        "B": ("mix_0 folded through the sampling",
              lambda lv: folded_iou_head(head, lv, segments, level_ids,
                                         strides)),
    }
    with torch.no_grad():
        a, b = (fn(levels).float() for _, fn in variants.values())
        rel = ((a - b).abs().max() / a.abs().max().clamp_min(1e-6)).item()
        for (name, (runs, fn)), extra in zip(variants.items(), (
                {}, {"rel_diff": rel, "rel_tol": AB_REL_TOL})):
            print_row({"probe": "iou_mix_probe", "config": cfg.name,
                       "batch_size": cfg.eval.batch_size,
                       "locations": a.shape[1], "row": name, "runs": runs,
                       **call_row(fn, (levels,), args.iters, dev), **extra})
    return 0


if __name__ == "__main__":
    sys.exit(main())
