"""The train step split into rows (port of scripts/train_probe.py).

    python -m drn_tpu_torch.probes.train_probe [--batch-size 384]
    python -m drn_tpu_torch.probes.train_probe --device cpu \\
        --config synthetic_tiny --batch-size 8 --iters 2      # a rehearsal

At `--config`'s width (charades_c3d_batched_eval) with seeded random
weights and bench.py's batch at `--batch-size`, each row is a chain timed
by `bench.chained_time` (each run's loss feeds the next run's features):

  - `loss_fwd`: the forward and `drn_loss`, no gradient;
  - `fwd_bwd`: + the backward (`train.loss_and_grads`);
  - `fwd_bwd_adam`: + the optimizer, the whole stage-1 step
    (`train.make_train_step`);
  - `fwd_bwd_without_<group>`: forward and backward with the group's
    parameters requiring no gradient (the JAX probe's `stop_gradient`):
    the difference to `fwd_bwd` is that group's weight gradients, and for
    the groups that take no gradient input (the query encoder, the
    backbone) their whole backward.

In eager PyTorch nothing is dead, so the rows do not fold the gradients
into the chain's scalar as the JAX probe does. Each row also carries its
model FLOPs (`utils.flops` on `plain_twin`, as `bench.train_model_flops`
counts: the kernels' recompute is not the model's; the optimizer adds
none) and mfu, their share of the H100's bf16 peak (none off the card).
One JSON line a row on stdout ({"row", "ms", "k1_ms", "clamped",
"flops_per_step", "mfu", "batch_size"}; `clamped`: `chained_time` found no
positive difference, so `ms` is no measurement), one line a row on
stderr. Runs on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import Dict, Iterable

import torch

# The JAX probe's groups, by the port's submodule names (DRN.owner).
GROUPS = {
    "query_encoder": ("query_encoder",),
    "backbone": ("backbone",),
    "fusion+fpn": ("fusion", "fpn"),
    "heads": ("heads",),
    "iou_head": ("iou_head",),
}


def loss_of(cfg, model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stage-1 loss of `batch`: the forward and `drn_loss`."""
    from drn_tpu_torch.models.losses import drn_loss

    out = model(batch["features"], batch["word_ids"], batch["query_mask"])
    loss, _ = drn_loss(cfg.model, cfg.train, out, model.locations,
                       model.level_ids, batch["gt_grid"], cfg.data.num_clips,
                       batch["valid"])
    return loss


@contextlib.contextmanager
def frozen(model, owners: Iterable[str]):
    """The parameters of the submodules `owners` require no gradient while
    the block runs; each parameter's flag is restored afterwards."""
    owners = set(owners)
    params = [p for k, p in model.state_dict(keep_vars=True).items()
              if model.owner(k) in owners]
    was = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, w in zip(params, was):
            p.requires_grad_(w)


def plain_twin(cfg, dev):
    """The model `evaluate.build_model` makes from seed 0, built from the
    kernels' plain versions, its optimizer's trainable set applied: what
    its steps count with `utils.flops` are the model's FLOPs, no
    recompute."""
    from drn_tpu_torch.evaluate import build_model
    from drn_tpu_torch.models.layers import PLAIN_OPS
    from drn_tpu_torch.train import make_optimizer

    plain = build_model(cfg, device=dev, seed=0, ops=PLAIN_OPS).train()
    make_optimizer(cfg, 1, plain)
    return plain


def config_at(name: str, batch_size=None):
    from drn_tpu_torch.config import get_config

    cfg = get_config(name)
    if batch_size:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   batch_size=batch_size))
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the train step, row by row")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--batch-size", type=int, default=384)
    p.add_argument("--iters", type=int, default=12,
                   help="chained steps per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import (Chain, chained_time, make_bench_batch,
                                     mfu_of)
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.train import (loss_and_grads, make_optimizer,
                                     make_train_step)
    from drn_tpu_torch.utils.flops import estimate_flops

    dev = resolve_device(args.device)
    cfg = config_at(args.config, args.batch_size)
    b = cfg.data.batch_size
    batch = make_bench_batch(cfg, batch_size=b, device=dev)
    model = build_model(cfg, device=dev, seed=0).train()
    opt = make_optimizer(cfg, 1, model)
    plain = plain_twin(cfg, dev)

    def fwd(m):
        def run(bt):
            with torch.no_grad():
                return loss_of(cfg, m, bt)
        return run

    def fwd_bwd(m):
        return lambda bt: loss_and_grads(cfg, m, bt)["loss"]

    def row(name, step, flops_step):
        per_step, t1, clamped = chained_time(
            Chain(step, batch, lambda s: s), args.iters)
        flops = estimate_flops(flops_step, batch)
        mfu = mfu_of(flops, per_step, dev)
        rec = {"row": name, "ms": per_step * 1e3, "k1_ms": t1 * 1e3,
               "clamped": clamped, "flops_per_step": flops, "mfu": mfu,
               "batch_size": b}
        print(f"{name:32s}: {per_step * 1e3:8.3f} ms"
              + (f", MFU {mfu * 100:.2f}%" if mfu else ""), file=sys.stderr,
              flush=True)
        print(json.dumps(rec), flush=True)

    row("loss_fwd", fwd(model), fwd(plain))
    row("fwd_bwd", fwd_bwd(model), fwd_bwd(plain))
    train_step = make_train_step(cfg, model, opt)
    row("fwd_bwd_adam", lambda bt: train_step(bt)["loss"], fwd_bwd(plain))
    for name, owners in GROUPS.items():
        with frozen(model, owners), frozen(plain, owners):
            row(f"fwd_bwd_without_{name}", fwd_bwd(model), fwd_bwd(plain))
    return 0


if __name__ == "__main__":
    sys.exit(main())
