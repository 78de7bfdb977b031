"""Where the eval step's (or, with --train, the train step's) time goes on
the card.

    python -m drn_tpu_torch.profile [--config charades_c3d_batched_eval]
        [--train] [--steps 10] [--trace profiles/eval_step_trace.json]

Builds the model at the config's full width with seeded weights, takes one
device-resident batch of the synthetic fixture (eval.batch_size examples,
or data.batch_size with --train), and prints one JSON line:

  * `step_ms`: host clock around synchronised runs of the whole step (a
    stage-1 train step with --train: forward, loss, backward, optimizer);
    `forward_ms`, eval only: the model forward alone (the rest is scoring,
    top-k, NMS and recall counts);
  * from a `torch.profiler` trace of `--steps` steps: the device time per
    step of every kernel (the sum, and the union of kernel intervals, whose
    complement in the step is the device's idle share), grouped by kernel
    name, the top ones listed, and the share of the port's own kernels.

Runs on `cuda` only; with no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from drn_tpu_torch.config import get_config
from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
from drn_tpu_torch.evaluate import (build_model, make_eval_step,
                                    resolve_device, to_device)
from drn_tpu_torch.train import make_optimizer, make_train_step
from drn_tpu_torch.utils.profiling import device_time, host_ms

OWN_KERNELS = ("conv_ln_relu_kernel", "stem_kernel", "row_stats_kernel")


def profile(config: str, steps: int, trace: str | None, top: int = 15,
            train: bool = False):
    dev = resolve_device("cuda")
    base = get_config(config)
    bsz = base.data.batch_size if train else base.eval.batch_size
    cfg = base.replace(data=dataclasses.replace(
        base.data, dataset="synthetic", synthetic_examples=bsz))
    model = build_model(cfg, device=dev, seed=0)
    batch = to_device(next(BatchIterator(
        make_dataset(cfg.data, cfg.model, split="train" if train else "test"),
        bsz, shuffle=False).epoch(0)), dev)
    forward_ms = None
    if train:
        model.train()
        step = make_train_step(cfg, model, make_optimizer(cfg, 1, model))
        step_ms = host_ms(lambda: step(batch), 10)
    else:
        step = make_eval_step(cfg, model)
        args = (batch["features"], batch["word_ids"], batch["query_mask"])
        step_ms = host_ms(lambda: step(batch), 20)
        with torch.no_grad():
            forward_ms = host_ms(lambda: model(*args), 20)

    path = Path(trace or ("profiles/train_step_trace.json" if train
                          else "profiles/eval_step_trace.json"))
    path.parent.mkdir(parents=True, exist_ok=True)
    stats = device_time(lambda: step(batch), steps, warmup=0, path=str(path))
    own_ms = sum(ms for name, _, ms in stats["by_name"]
                 if any(o in name for o in OWN_KERNELS))
    return {
        "phase": "profile_train" if train else "profile", "config": cfg.name,
        "batch_size": bsz, "steps": steps,
        "step_ms": step_ms, "forward_ms": forward_ms,
        "kernels_per_step": stats["kernels"],
        "device_kernel_ms_per_step": stats["kernel_ms"],
        "device_busy_ms_per_step": stats["busy_ms"],
        "device_idle_share": max(0.0, 1.0 - stats["busy_ms"] / step_ms),
        "own_kernel_share_of_device": own_ms / stats["kernel_ms"],
        "top": [{"name": name[:120], "launches_per_step": n,
                 "ms_per_step": ms} for name, n, ms in stats["by_name"][:top]],
        "trace": str(path),
        "device": torch.cuda.get_device_name(dev),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--train", action="store_true",
                   help="profile the stage-1 train step instead")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--trace", default=None,
                   help="chrome-trace output (default profiles/...)")
    args = p.parse_args(argv)
    print(json.dumps(profile(args.config, args.steps, args.trace,
                             train=args.train)))


if __name__ == "__main__":
    main()
