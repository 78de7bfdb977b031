"""The modules after the backbone, one by one (port of
scripts/profile_residual.py).

    python -m drn_tpu_torch.probes.profile_residual [--config ...]
    python -m drn_tpu_torch.probes.profile_residual --config tacos_c3d
    python -m drn_tpu_torch.probes.profile_residual --device cpu \\
        --config synthetic_tiny --iters 1                     # a rehearsal

At `--config`'s eval shapes (charades_c3d_batched_eval: B=48, T=64, 3
levels, D=512) with seeded random weights (`evaluate.build_model(seed=0)`)
and the script's inputs from seed 0, same draws in the same order: bf16
levels (B, T / 2**l, D) and per-level bf16 queries (B, D), normal; sorted
uniform segments (B, N, 2) over the base grid; the flat location metadata
(`models/drn.py::location_metadata`). One row each, every one chained
through the levels alone:

  - `fusion_x3`: the fusion of every level (`fused_fusion_block`);
  - `fpn`: the temporal FPN (`conv_ln_relu` laterals and smooths);
  - `grounding_heads`: the two towers on the gap-padded concat and their
    output convs;
  - `iou_head`: the IoU head, sampling and mixes (`conv_ln_relu`);
  - `iou_sampling_only`: the port's production sampling alone, per level
    by gather (`models/heads.py::segment_samples`, what the IoU head runs
    before its mixes). The JAX script's row runs the JAX package's
    one-hot selection matmuls, flat or blocked by level.

Each row (`bench.call_row`): the host clock's time a call of a chain of
`--iters` calls, with `clamped`; the device time a call from a profiler
trace (summed and union), and the kernels a call. One JSON line a row on
stdout. Runs on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def make_inputs(cfg, dev, seed: int = 0, queries: bool = True):
    """The script's draws: (levels, queries, segments) on `dev`, levels
    and queries bf16, segments fp32. Without `queries` (iou_mix_probe's
    script draws none) none are drawn and the second item is None."""
    m = cfg.model
    b, base = cfg.eval.batch_size, cfg.data.num_clips
    rng = np.random.default_rng(seed)
    sizes = [base // 2 ** l for l in range(m.num_levels)]
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        dev, torch.bfloat16)
    levels = [bf16(rng.normal(size=(b, t, m.hidden_dim))) for t in sizes]
    qs = [bf16(rng.normal(size=(b, m.hidden_dim))) for _ in sizes] \
        if queries else None
    segments = torch.from_numpy(np.sort(rng.uniform(
        0, base, size=(b, sum(sizes), 2)), axis=-1).astype(np.float32)
    ).to(dev)
    return levels, qs, segments


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the modules after the "
                                            "backbone, one by one")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--iters", type=int, default=16,
                   help="chained calls per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import call_row, print_row
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.models.drn import location_metadata
    from drn_tpu_torch.models.heads import segment_positions, segment_samples

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    levels, queries, segments = make_inputs(cfg, dev)
    _, strides, level_ids = location_metadata(cfg.model, cfg.data.num_clips,
                                              dev)
    model = build_model(cfg, device=dev, seed=0)
    sizes = [t.shape[1] for t in levels]

    def sampling_only(lv):
        return segment_samples(lv, segment_positions(sizes, segments,
                                                     level_ids, strides))

    for name, fn in (
            ("fusion_x3", lambda lv: model.fusion(lv, queries)),
            ("fpn", model.fpn),
            ("grounding_heads", model.heads),
            ("iou_head", lambda lv: model.iou_head(lv, segments, level_ids,
                                                   strides)),
            ("iou_sampling_only", sampling_only)):
        with torch.no_grad():
            rec = call_row(fn, (levels,), args.iters, dev)
        print_row({"probe": "profile_residual", "config": cfg.name,
                   "batch_size": cfg.eval.batch_size,
                   "locations": sum(sizes), "row": name, **rec})
    return 0


if __name__ == "__main__":
    sys.exit(main())
