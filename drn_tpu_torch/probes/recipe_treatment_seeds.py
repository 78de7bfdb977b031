"""Multi-seed trained-head rescore, paired with the untrained control
(port of scripts/recipe_treatment_seeds.py).

    python -m drn_tpu_torch.probes.recipe_treatment_seeds \\
        --config synthetic_recipe_flagship --seeds 4 \\
        --w-sweep 0.25,0.5,0.75 --workdir /tmp/drn_treatment
    ... --device cpu --config synthetic_tiny --seeds 2 \\
        --stage2-epochs 1 --workdir D                       # a rehearsal

Stage 1 is trained once (`<workdir>/<cfg.name>/stage1`, reused when its
best exists, as a `recipe_demo` run in the same workdir leaves it). Then
for each seed s:

  - the stage-1 best with only the IoU head redrawn from seed s
    (`recipe_demo.fresh_iou_head`), evaluated with rescoring: the control
    `untrained_seed{s}`;
  - that variant saved as a params-only step (step 0, no optimizer state)
    in `<workdir>/seed{s}/stage1_variant`, from which stage 2 (IoU head
    only, its data order seeded by s too) trains into
    `<workdir>/seed{s}/<cfg.name>/stage2`;
  - its best evaluated with rescoring: the treatment `trained_seed{s}`,
    and at each blend exponent of `--w-sweep` (`trained_seed{s}_w{w}`).

Resumable: every row lands in `<workdir>/treatment_state.json` (the JAX
key names) as soon as it is measured, and rows, stage 1 and stage-2 runs
already there are skipped on a rerun. The summary aggregates every seed
the state holds. Between seeds the previous seed's trained model and
optimizer are dropped and `torch.cuda.empty_cache()` called (the JAX
script clears its compile caches there); each seed's peak device memory
is printed, so that any growth shows.

Output: stderr progress, a `run` JSON line (seconds a stage, launches a
stage, each seed's peak memory), the table, then the JAX script's summary
line. Runs on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from drn_tpu_torch.probes.recipe_demo import (best_params, ensure_stage1,
                                              eval_row, fresh_iou_head,
                                              load_state, peak_mb, pin_w1,
                                              print_table, r1_mean, release,
                                              save_state, splice_iou_head,
                                              stage_config, timed,
                                              val_eval_fn, val_split)

STATE_FILE = "treatment_state.json"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="paired multi-seed trained-vs-untrained rescore")
    p.add_argument("--config", default="synthetic_recipe_flagship")
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--stage1-seed", type=int, default=0)
    p.add_argument("--stage2-epochs", type=int, default=None)
    p.add_argument("--w-sweep", default="",
                   help="comma-separated extra blend exponents w to eval "
                        "each TRAINED head at (w=1 always evaluated)")
    p.add_argument("--workdir", required=True,
                   help="persistent dir: stage-1 checkpoint, per-seed "
                        "stage-2 checkpoints, and the resumable state file")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch import train as trainer
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.utils.checkpoint import CheckpointManager

    dev = resolve_device(args.device)
    t0 = time.perf_counter()

    def log(msg):
        print(f"[treatment +{time.perf_counter() - t0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    run = {"seconds": {}, "launches": {}, "peak_mb": {}}
    os.makedirs(args.workdir, exist_ok=True)
    state = load_state(args.workdir, STATE_FILE, {"rows": {}})
    rows = state["rows"]
    # In-training val selection at w=1 (the committed r5 logs'); every
    # row below passes its own w, so the sweep is unaffected.
    cfg = pin_w1(get_config(args.config))
    model = build_model(cfg, device=dev)  # one model: every row loads into it
    val = val_split(cfg)
    w_extra = [float(w) for w in args.w_sweep.split(",") if w.strip()]

    stage1_dir = timed(run, "stage1", lambda: ensure_stage1(
        cfg, args.workdir, args.stage1_seed, dev, val, log))
    params1 = best_params(cfg, stage1_dir)
    if "baseline_plain" not in rows:
        model.load_state_dict(params1)
        rows["baseline_plain"] = eval_row(cfg, model, val, rescore=False)
        save_state(args.workdir, STATE_FILE, state)
    log(f"baseline (no rescore): "
        f"R@1-mean {r1_mean(rows['baseline_plain']):.2f}")

    for seed in range(args.seed_start, args.seeds):
        release(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tag_u, tag_t = f"untrained_seed{seed}", f"trained_seed{seed}"
        seed_root = f"{args.workdir}/seed{seed}"
        variant_dir = f"{seed_root}/stage1_variant"
        stage2_dir = f"{seed_root}/{cfg.name}/stage2"

        need_train = not os.path.isdir(os.path.join(stage2_dir, "best"))
        if tag_u not in rows or need_train:
            # The stage-1 best with ONLY the IoU head redrawn from seed s:
            # the control probe's perturbation.
            pseed = splice_iou_head(params1, fresh_iou_head(model, seed))
            if tag_u not in rows:
                model.load_state_dict(pseed)
                rows[tag_u] = eval_row(cfg, model, val, rescore=True)
                save_state(args.workdir, STATE_FILE, state)
                log(f"seed {seed} control (untrained head): "
                    f"R@1-mean {r1_mean(rows[tag_u]):.2f}")
            if need_train:
                # The variant, as a params-only step: stage 2's init.
                CheckpointManager(variant_dir).save(
                    0, {"model": pseed, "step": 0}, force=True)
                cfg2 = stage_config(cfg, 2, seed_root, seed,
                                    args.stage2_epochs,
                                    stage2_iou_only=True)
                log(f"seed {seed} stage 2 ({cfg2.train.num_epochs} epochs, "
                    f"IoU-only) -> {stage2_dir}")
                timed(run, f"seed{seed}_stage2", lambda: trainer.train(
                    cfg2, device=dev, init_from=variant_dir,
                    eval_fn=val_eval_fn(cfg2, val)))
        params2 = best_params(cfg, stage2_dir)
        model.load_state_dict(params2)
        if tag_t not in rows:
            rows[tag_t] = eval_row(cfg, model, val, rescore=True)
            save_state(args.workdir, STATE_FILE, state)
        log(f"seed {seed} treatment (trained head):  "
            f"R@1-mean {r1_mean(rows[tag_t]):.2f}")
        for w in w_extra:
            tag_w = f"trained_seed{seed}_w{w:g}"
            if tag_w not in rows:
                rows[tag_w] = eval_row(cfg, model, val, rescore=True, w=w)
                save_state(args.workdir, STATE_FILE, state)
            log(f"seed {seed} trained @ w={w:g}: "
                f"R@1-mean {r1_mean(rows[tag_w]):.2f}  "
                f"R@5,0.5={rows[tag_w].get('R@5,IoU=0.5', float('nan')):.2f}")
        run["peak_mb"][f"seed{seed}"] = peak_mb(dev)
        if dev.type == "cuda":
            log(f"seed {seed} peak device memory: "
                f"{run['peak_mb'][f'seed{seed}']:.1f} MB")

    # Every seed present in the state, not just this invocation's range:
    # a resumed run must still report the whole multi-seed table.
    seeds = sorted(s for s in range(max(args.seeds, 64))
                   if f"trained_seed{s}" in rows
                   and f"untrained_seed{s}" in rows)
    u = [r1_mean(rows[f"untrained_seed{s}"]) for s in seeds]
    t = [r1_mean(rows[f"trained_seed{s}"]) for s in seeds]
    base = r1_mean(rows["baseline_plain"])
    paired = [round(b - a, 2) for a, b in zip(u, t)]

    run["seconds"]["total"] = time.perf_counter() - t0
    print(json.dumps({"run": "recipe_treatment_seeds",
                      "config": args.config, **run, "device": str(dev)}),
          flush=True)
    print_table({tag: rows[tag] for tag in (
        ["baseline_plain"] + [f"untrained_seed{s}" for s in seeds]
        + [f"trained_seed{s}" for s in seeds]
        + [f"trained_seed{s}_w{w:g}" for s in seeds for w in w_extra
           if f"trained_seed{s}_w{w:g}" in rows])}, "row")
    print(json.dumps({
        "probe": "paired_trained_vs_untrained_rescore",
        "config": args.config,
        "seeds": seeds,
        "baseline_plain_r1_mean": round(base, 2),
        "untrained_r1_means": [round(v, 2) for v in u],
        "trained_r1_means": [round(v, 2) for v in t],
        "untrained_mean": round(sum(u) / len(u), 2),
        "trained_mean": round(sum(t) / len(t), 2),
        "untrained_span": [round(min(u), 2), round(max(u), 2)],
        "trained_span": [round(min(t), 2), round(max(t), 2)],
        "paired_trained_minus_untrained": paired,
        "trained_minus_baseline": [round(v - base, 2) for v in t],
        "w_sweep": {
            f"w{w:g}": {
                "r1_means": [round(r1_mean(
                    rows[f"trained_seed{s}_w{w:g}"]), 2) for s in seeds
                    if f"trained_seed{s}_w{w:g}" in rows],
                "r5_05": [rows[f"trained_seed{s}_w{w:g}"].get("R@5,IoU=0.5")
                          for s in seeds
                          if f"trained_seed{s}_w{w:g}" in rows],
            } for w in w_extra
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
