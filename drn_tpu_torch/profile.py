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
from collections import defaultdict
from pathlib import Path

import torch

from drn_tpu_torch.config import get_config
from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
from drn_tpu_torch.evaluate import (build_model, make_eval_step,
                                    resolve_device, to_device)
from drn_tpu_torch.train import make_optimizer, make_train_step
from drn_tpu_torch.utils.profiling import host_ms

OWN_KERNELS = ("conv_ln_relu_kernel", "stem_kernel", "row_stats_kernel")


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


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

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    path = Path(trace or ("profiles/train_step_trace.json" if train
                          else "profiles/eval_step_trace.json"))
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the card")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    busy_us = sum(v[1] for v in by_name.values())
    union_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    own_us = sum(v[1] for k, v in by_name.items()
                 if any(o in k for o in OWN_KERNELS))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "phase": "profile_train" if train else "profile", "config": cfg.name,
        "batch_size": bsz, "steps": steps,
        "step_ms": step_ms, "forward_ms": forward_ms,
        "kernels_per_step": len(kernels) / steps,
        "device_kernel_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_ms_per_step": union_us / 1e3 / steps,
        "device_idle_share": max(0.0, 1.0 - union_us / 1e3 / steps / step_ms),
        "own_kernel_share_of_device": own_us / busy_us,
        "top": [{"name": k[:120], "launches_per_step": v[0] / steps,
                 "ms_per_step": v[1] / 1e3 / steps} for k, v in ranked],
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
