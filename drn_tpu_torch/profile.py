"""Where the eval step's (or, with --train, the train step's) time goes on
the card.

    python -m drn_tpu_torch.profile [--config charades_c3d_batched_eval]
        [--train] [--steps 10] [--trace profiles/eval_step_trace.json]

Builds the model at the config's full width with seeded weights, takes one
device-resident batch of the synthetic fixture (eval.batch_size examples,
or data.batch_size with --train), and prints one JSON line:

  * `step_ms`: host clock around pipelined runs of the whole step (a
    stage-1 train step with --train: forward, loss, backward, optimizer),
    with no profiler running;
  * from ONE `torch.profiler` trace of `--steps` steps, a step each: the
    trace's window (`traced_step_ms`), the device's busy time in it and
    its idle share (`idle_share`, 1 − busy ÷ window, both from that
    trace), the kernels by name, the top ones listed, the share of the
    port's own kernels, and `spans`: for each of the program's ranges
    (`drn.eval.*`, `drn.train.*`, `drn.model.<part>`;
    utils/profiling.py::span) the device ms of the kernels launched
    inside it (children included), of those it launched in its own time,
    and the device's idle ms while it was the innermost range open on
    the main thread; `outside`, the same of what no range holds.

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
from drn_tpu_torch.utils.profiling import host_ms, kernel_stats, span_table

OWN_KERNELS = ("conv_ln_relu_kernel", "column_sums_kernel", "stem_kernel",
               "row_stats_kernel")


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
    if train:
        model.train()
        step = make_train_step(cfg, model, make_optimizer(cfg, 1, model))
    else:
        step = make_eval_step(cfg, model)
    step_ms = host_ms(lambda: step(batch), 10 if train else 20)

    path = Path(trace or ("profiles/train_step_trace.json" if train
                          else "profiles/eval_step_trace.json"))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    stats = kernel_stats([e for e in events if e.get("cat") == "kernel"],
                         steps)
    if not stats["kernels"]:
        raise RuntimeError("the profiler recorded no kernel on the card")
    spans = span_table(events, steps)
    own_ms = sum(ms for name, _, ms in stats["by_name"]
                 if any(o in name for o in OWN_KERNELS))
    return {
        "phase": "profile_train" if train else "profile", "config": cfg.name,
        "batch_size": bsz, "steps": steps,
        "step_ms": step_ms, "traced_step_ms": spans["window_ms"],
        "kernels_per_step": stats["kernels"],
        "device_kernel_ms_per_step": stats["kernel_ms"],
        "device_busy_ms_per_step": spans["busy_ms"],
        "idle_share": 1.0 - spans["busy_ms"] / spans["window_ms"],
        "own_kernel_share_of_device": own_ms / stats["kernel_ms"],
        "spans": spans["spans"], "outside": spans["outside"],
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
