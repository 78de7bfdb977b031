"""How much of the untrained-IoU-head rescore row is seed luck? (port of
scripts/recipe_untrained_rescore_probe.py)

    python -m drn_tpu_torch.probes.recipe_untrained_rescore_probe \\
        --workdir <recipe_demo workdir>/synthetic_recipe_flagship/stage1 \\
        --config synthetic_recipe_flagship --seeds 6
    ... --device cpu --config synthetic_tiny --seeds 2      # a rehearsal

Holds a stage-1 checkpoint fixed (its best) and redraws only the IoU head,
from seed s for s in [--seed-start, --seeds) (`recipe_demo.fresh_iou_head`:
the head a model of the config starts with at that seed), evaluating the
val split with rescoring each time. Rows: `stage1_plain` (no rescore),
`untrained_seed{s}`. A wide spread (seeds at or below the baseline) says
the untrained row is ranking jitter; a tight one above the trained head
says the trained head adds nothing at this width. The blend is pinned to
w=1 as in the JAX probe.

Output: a `run` JSON line (seconds, launches, peak device memory), then
the JAX probe's summary line (`probe`, `config`, `stage1_plain_r1_mean`,
`untrained_r1_means`, `spread`, `results`). Runs on `cuda` unless
`--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from drn_tpu_torch.probes.recipe_demo import (best_params, eval_with,
                                              fresh_iou_head, launch_delta,
                                              peak_mb, pin_w1, r1_mean,
                                              rounded, splice_iou_head,
                                              val_split)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="seed-spread of the untrained-IoU-head rescore")
    p.add_argument("--workdir", required=True,
                   help="stage-1 checkpoint dir from "
                        "drn_tpu_torch.probes.recipe_demo")
    p.add_argument("--config", default="synthetic_recipe_flagship")
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--seed-start", type=int, default=0,
                   help="first seed (--seeds is the exclusive end)")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    if args.seed_start >= args.seeds:
        p.error(f"--seed-start {args.seed_start} >= --seeds {args.seeds}: "
                f"empty seed range (--seeds is the EXCLUSIVE end bound, "
                f"not a count)")

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.ops.cuda import launch_counts

    dev = resolve_device(args.device)
    t0, counts = time.perf_counter(), launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = pin_w1(get_config(args.config))
    params = best_params(cfg, args.workdir)  # stage-1 best-on-val
    model = build_model(cfg, device=dev)
    model.load_state_dict(params)
    val = val_split(cfg)

    def log(tag, r):
        print(f"[probe +{time.perf_counter() - t0:6.1f}s] {tag}: "
              + "  ".join(f"{k}={r[k]:.2f}" for k in sorted(r)
                          if k.startswith("R@1") or k == "mIoU"),
              file=sys.stderr, flush=True)

    rows = {"stage1_plain": eval_with(cfg, model, False, dataset=val)}
    log("stage1, no rescore", rows["stage1_plain"])
    for seed in range(args.seed_start, args.seeds):
        model.load_state_dict(splice_iou_head(
            params, fresh_iou_head(model, seed)))
        rows[f"untrained_seed{seed}"] = eval_with(cfg, model, True,
                                                  dataset=val)
        log(f"rescore, untrained head seed {seed}",
            rows[f"untrained_seed{seed}"])

    means = {k: r1_mean(r) for k, r in rows.items()}
    seed_means = [v for k, v in means.items() if k.startswith("untrained")]
    print(json.dumps({"run": "recipe_untrained_rescore_probe",
                      "config": args.config,
                      "seconds": time.perf_counter() - t0,
                      "launches": launch_delta(counts),
                      "peak_mb": peak_mb(dev), "device": str(dev)}),
          flush=True)
    print(json.dumps({
        "probe": "untrained_rescore_seed_spread",
        "config": args.config,
        "stage1_plain_r1_mean": round(means["stage1_plain"], 2),
        "untrained_r1_means": [round(v, 2) for v in seed_means],
        "spread": round(max(seed_means) - min(seed_means), 2),
        "results": rounded(rows),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
