"""The two-stage recipe at the flagship width on the synthetic fixture
(port of scripts/atscale_synthetic.py).

    python -m drn_tpu_torch.probes.atscale_synthetic [--epochs1 60 --epochs2 40]
    python -m drn_tpu_torch.probes.atscale_synthetic --device cpu \\
        --config synthetic_tiny --train-examples 64 --test-examples 32 \\
        --epochs1 2 --epochs2 2 --batch-size 8              # a rehearsal

`charades_c3d`'s width (hidden 512, C3D 4096-d features, T=64) on the
synthetic fixture: 512 training and 128 held-out examples, batches of 64
(eval 64), one model from seed 0. Stage 1 (60 epochs) through the train
step alone (`train.make_train_step`: no periodic eval, no checkpoint),
the held-out recall with the match score only; stage 2 (40 epochs, IoU
head only, a fresh optimizer on the same model), the held-out recall with
IoU rescoring (w=1). Two checks fail the run (AssertionError, in this
order): the IoU-only stage 2 left every parameter outside the IoU head
bit-identical, and rescoring lifted R@1,IoU=0.5.

`--config` and `--train-examples` / `--test-examples` exist so that a CPU
rehearsal can run at `synthetic_tiny`; their defaults are the script's.
Output: stderr progress, one JSON line (both evaluations, the lift, the
keys the freeze moved, seconds and the package kernels' launches a stage,
peak device memory), then `ATSCALE OK`. Runs on `cuda` unless `--device
cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from drn_tpu_torch.train import make_optimizer, make_train_step


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the recipe at scale, synthetic")
    p.add_argument("--epochs1", type=int, default=60)
    p.add_argument("--epochs2", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--train-examples", type=int, default=512)
    p.add_argument("--test-examples", type=int, default=128)
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import BatchIterator
    from drn_tpu_torch.data.synthetic import SyntheticDataset
    from drn_tpu_torch.evaluate import (build_model, evaluate,
                                        resolve_device, to_device)
    from drn_tpu_torch.probes.recipe_demo import (moved_outside_iou_head,
                                                  peak_mb, timed)

    dev = resolve_device(args.device)
    base = get_config(args.config)
    base = base.replace(
        data=dataclasses.replace(base.data, dataset="synthetic",
                                 batch_size=args.batch_size),
        # w=1, the reference's exact product, as the committed at-scale
        # logs were produced.
        eval=dataclasses.replace(base.eval, batch_size=64,
                                 score_iou_weight=1.0),
    )
    ds_train = SyntheticDataset(base.data, base.model, split="train",
                                num_examples=args.train_examples)
    ds_test = SyntheticDataset(base.data, base.model, split="test",
                               num_examples=args.test_examples)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(base, device=dev)
    rec = {"probe": "atscale_synthetic", "config": args.config,
           "train_examples": args.train_examples,
           "test_examples": args.test_examples,
           "batch_size": args.batch_size, "epochs1": args.epochs1,
           "epochs2": args.epochs2}

    def run_stage(cfg, epochs, tag):
        batches = BatchIterator(ds_train, cfg.data.batch_size, shuffle=True,
                                seed=0)
        step = make_train_step(cfg, model, make_optimizer(
            cfg, len(batches), model))
        model.train()  # cuDNN's LSTM backward runs in training mode only
        for e in range(epochs):
            for batch in batches.epoch(e):
                m = step(to_device(batch, dev))
            if (e + 1) % 10 == 0 or e + 1 == epochs:
                log(f"{tag} epoch {e + 1}: " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in sorted(m.items())))

    def held_out(rescore):
        c = base.replace(eval=dataclasses.replace(
            base.eval, score_use_iou_head=rescore))
        return evaluate(c, model, ds_test, device=dev)

    timed(rec, "stage1", lambda: run_stage(base.replace(
        train=dataclasses.replace(base.train, stage=1)), args.epochs1,
        "stage1"))
    params1 = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    r_match = timed(rec, "stage1_eval", lambda: held_out(False))
    log("stage1 (match-only scoring): "
        + " ".join(f"{k}={v:.1f}" for k, v in sorted(r_match.items())))

    timed(rec, "stage2", lambda: run_stage(base.replace(
        train=dataclasses.replace(base.train, stage=2,
                                  stage2_iou_only=True)), args.epochs2,
        "stage2"))
    moved = moved_outside_iou_head(model, params1, model.state_dict())
    r_iou = timed(rec, "stage2_eval", lambda: held_out(True))
    log("stage2 (IoU rescoring):      "
        + " ".join(f"{k}={v:.1f}" for k, v in sorted(r_iou.items())))
    lift = {k: r_iou[k] - r_match[k] for k in r_match}
    log("lift: " + " ".join(f"{k}={v:+.1f}" for k, v in sorted(lift.items())))
    rec.update(stage1_match=r_match, stage2_rescore=r_iou, lift=lift,
               moved_outside_iou_head=moved, peak_mb=peak_mb(dev),
               device=str(dev))
    print(json.dumps(rec), flush=True)

    # The IoU-only freeze must leave every non-IoU-head param bit-identical.
    if moved:
        raise AssertionError(f"the stage-2 freeze moved {moved}")
    log("stage-2 freeze verified: non-IoU params bit-identical")
    if not r_iou["R@1,IoU=0.5"] > r_match["R@1,IoU=0.5"]:
        raise AssertionError("IoU rescoring did not lift R@1,IoU=0.5")
    print("ATSCALE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
