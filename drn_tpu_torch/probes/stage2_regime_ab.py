"""Stage-2 regime A/B: IoU-only freeze against joint fine-tuning (port of
scripts/stage2_regime_ab.py).

    python -m drn_tpu_torch.probes.stage2_regime_ab --config \\
        synthetic_recipe --seeds 3 --workdir /tmp/drn_regime_ab
    ... --device cpu --config synthetic_tiny --seeds 1 \\
        --stage2-epochs 1 --workdir D                       # a rehearsal

Stage 1 once (`<workdir>/<cfg.name>/stage1`, reused when its best exists),
then three stage-2 regimes from its best, each over seeds 0..--seeds-1
(the seed drives stage 2's data order):

    freeze      -- IoU head only, base LR      (the demonstrated recipe)
    joint       -- everything, base LR
    joint_lowlr -- everything, base LR x 0.1

Each is judged on the val split with rescoring (w=1) by R@1-mean and
R@5,IoU=0.5 (`<regime>_seed{s}`); `<regime>_seed{s}_plain` (no rescore)
shows whether joint fine-tuning moved the grounding heads. Resumable:
rows in `<workdir>/regime_ab_state.json` (the JAX file's layout), each
finished stage-2 run (`<workdir>/<tag>/<cfg.name>/stage2/best`) reused.

Output: stderr progress, a `run` JSON line (seconds and launches a run,
peak device memory), the table, then the JAX script's summary line. Runs
on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from drn_tpu_torch.probes.recipe_demo import (best_params, ensure_stage1,
                                              eval_row, load_state, peak_mb,
                                              pin_w1, print_table, r1_mean,
                                              release, save_state,
                                              stage_config, timed,
                                              val_eval_fn, val_split)

REGIMES = {
    "freeze": dict(stage2_iou_only=True, lr_scale=1.0),
    "joint": dict(stage2_iou_only=False, lr_scale=1.0),
    "joint_lowlr": dict(stage2_iou_only=False, lr_scale=0.1),
}
STATE_FILE = "regime_ab_state.json"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="stage-2 regime A/B")
    p.add_argument("--config", default="synthetic_recipe")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--stage2-epochs", type=int, default=None)
    p.add_argument("--workdir", required=True)
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch import train as trainer
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()

    def log(msg):
        print(f"[regime_ab +{time.perf_counter() - t0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    run = {"seconds": {}, "launches": {}}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    os.makedirs(args.workdir, exist_ok=True)
    rows = load_state(args.workdir, STATE_FILE, {})
    # w=1 (the reference's exact product), as the committed A/B ran.
    cfg = pin_w1(get_config(args.config))
    model = build_model(cfg, device=dev)
    val = val_split(cfg)
    stage1_dir = timed(run, "stage1", lambda: ensure_stage1(
        cfg, args.workdir, 0, dev, val, log))
    model.load_state_dict(best_params(cfg, stage1_dir))
    if "stage1_plain" not in rows:
        rows["stage1_plain"] = eval_row(cfg, model, val, rescore=False)
        save_state(args.workdir, STATE_FILE, rows)
    log(f"stage1 baseline R@1-mean {r1_mean(rows['stage1_plain']):.2f}")

    for seed in range(args.seeds):
        for name, r in REGIMES.items():
            tag = f"{name}_seed{seed}"
            run_root = f"{args.workdir}/{tag}"
            stage2_dir = f"{run_root}/{cfg.name}/stage2"
            if not os.path.isdir(os.path.join(stage2_dir, "best")):
                release(dev)
                log(f"{tag}: stage 2 (iou_only={r['stage2_iou_only']}, "
                    f"lr x{r['lr_scale']})")
                cfg2 = stage_config(
                    cfg, 2, run_root, seed, args.stage2_epochs,
                    stage2_iou_only=r["stage2_iou_only"],
                    learning_rate=cfg.train.learning_rate * r["lr_scale"])
                timed(run, tag, lambda: trainer.train(
                    cfg2, device=dev, init_from=stage1_dir,
                    eval_fn=val_eval_fn(cfg2, val)))
            if tag not in rows:
                model.load_state_dict(best_params(cfg, stage2_dir))
                rows[tag] = eval_row(cfg, model, val, rescore=True)
                rows[tag + "_plain"] = eval_row(cfg, model, val,
                                                rescore=False)
                save_state(args.workdir, STATE_FILE, rows)
            log(f"{tag}: rescored R@1-mean {r1_mean(rows[tag]):.2f}  "
                f"plain {r1_mean(rows[tag + '_plain']):.2f}")

    run["seconds"]["total"] = time.perf_counter() - t0
    run["peak_mb"] = peak_mb(dev)
    print(json.dumps({"run": "stage2_regime_ab", "config": args.config,
                      **run, "device": str(dev)}), flush=True)
    print_table({tag: rows[tag] for tag in sorted(rows)}, "row")

    summary = {"probe": "stage2_regime_ab", "config": args.config,
               "stage1_r1_mean": round(r1_mean(rows["stage1_plain"]), 2)}
    for name in REGIMES:
        vals = [r1_mean(rows[f"{name}_seed{s}"])
                for s in range(args.seeds) if f"{name}_seed{s}" in rows]
        r5 = [rows[f"{name}_seed{s}"].get("R@5,IoU=0.5")
              for s in range(args.seeds) if f"{name}_seed{s}" in rows]
        summary[name] = {
            "r1_means": [round(v, 2) for v in vals],
            "r1_mean_of_means": round(sum(vals) / len(vals), 2),
            "r5_05": r5,
        }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
