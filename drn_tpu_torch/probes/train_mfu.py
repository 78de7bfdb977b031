"""Where the train step's time goes, probe by probe, with each probe's share
of the card's peak (port of scripts/train_mfu_probe.py).

    python -m drn_tpu_torch.probes.train_mfu --probes fwd,grad,full,adam
    python -m drn_tpu_torch.probes.train_mfu \\
        --probes grad_noenc,grad_remat,fp32
    python -m drn_tpu_torch.probes.train_mfu --device cpu \\
        --config synthetic_tiny --iters 2                  # a rehearsal

At `--config`'s width and its training batch (or `--batch-size`), seeded
random weights, bench.py's batch, each probe is a chain timed by
`bench.chained_time`:

  - `fwd`: the forward and `drn_loss`, no gradient;
  - `grad`: + the backward (`train.loss_and_grads`);
  - `full`: + the optimizer (`train.make_train_step`);
  - `adam`: the optimizer alone, on constant gradients (1e-6 each),
    chained through the parameters it updates;
  - `grad_noenc`: `grad` with the query encoder's parameters (its
    embedding and BiLSTM) requiring no gradient: the LSTM's backward
    drops out;
  - `grad_remat`: `grad` with the loss recomputed in the backward
    (`torch.utils.checkpoint`, where the JAX probe uses `jax.checkpoint`);
  - `fp32`: `grad` of a model at model.dtype="float32", built from the
    kernels' plain versions (the kernels take bf16 only, so on the card
    this model runs none of them). Its own model: the JAX probe switched
    the whole run to fp32 when `fp32` was among the probes.

Each probe prints one line to stderr and one JSON line to stdout: ms a step,
the k=1 chain's ms, `clamped` (`chained_time` found no positive
difference: no measurement), its model's matmul + conv FLOPs
(`utils.flops` on `train_probe.plain_twin`, as `bench.train_model_flops`
counts: the kernels' recompute and `grad_remat`'s are not the model's)
and mfu, their share of the H100's bf16 peak (none off the card).
`fwd`, `grad`, `full` and `grad_noenc` time the steps of train_probe's
`loss_fwd`, `fwd_bwd`, `fwd_bwd_adam` and `fwd_bwd_without_query_encoder`
rows, which carry the same columns: a run of both needs only `adam`,
`grad_remat` and `fp32` here. Runs on `cuda` unless `--device cpu`; with
no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

PROBES = ("fwd", "grad", "full", "adam", "grad_noenc", "grad_remat", "fp32")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="train-step MFU probes")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--iters", type=int, default=24)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--probes", default="fwd,grad,full,adam",
                   help=f"comma-separated, of {','.join(PROBES)}")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    probes = args.probes.split(",")
    unknown = sorted(set(probes) - set(PROBES))
    if unknown:
        p.error(f"unknown probes {unknown}")

    from torch.utils.checkpoint import checkpoint

    from drn_tpu_torch.bench import (Chain, chained_time, make_bench_batch,
                                     mfu_of, phase)
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.probes.train_probe import (config_at, frozen, loss_of,
                                                  plain_twin)
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
    phase(f"B={b} probes={probes} dtype={cfg.model.dtype}")

    def timed(label, step, flops_step, dtype=cfg.model.dtype):
        per_step, t1, clamped = chained_time(
            Chain(step, batch, lambda s: s), args.iters)
        flops = estimate_flops(flops_step, batch) if flops_step else 0.0
        mfu = mfu_of(flops, per_step, dev)
        phase(f"{label}: {per_step * 1e3:.3f} ms/step (k1 {t1 * 1e3:.1f} ms)"
              + (f", MFU {mfu * 100:.2f}%" if mfu else ""))
        print(json.dumps({"probe": label, "ms": per_step * 1e3,
                          "k1_ms": t1 * 1e3, "clamped": clamped,
                          "flops_per_step": flops,
                          "mfu": mfu, "batch_size": b, "dtype": dtype}),
              flush=True)

    def fwd(m):
        def run(bt):
            with torch.no_grad():
                return loss_of(cfg, m, bt)
        return run

    def grad(cfg_, m):
        return lambda bt: loss_and_grads(cfg_, m, bt)["loss"]

    for probe in probes:
        if probe == "fwd":
            timed(probe, fwd(model), fwd(plain))
        elif probe == "grad":
            timed(probe, grad(cfg, model), grad(cfg, plain))
        elif probe == "full":
            step = make_train_step(cfg, model, opt)
            timed(probe, lambda bt: step(bt)["loss"], grad(cfg, plain))
        elif probe == "adam":
            params = list(opt.params.values())
            for prm in params:
                prm.grad = torch.full_like(prm, 1e-6)
            first = params[0]

            def adam(bt):
                opt.step()
                return first.reshape(-1)[0].clone()
            timed(probe, adam, None)
        elif probe == "grad_noenc":
            with frozen(model, ("query_encoder",)), \
                    frozen(plain, ("query_encoder",)):
                timed(probe, grad(cfg, model), grad(cfg, plain))
        elif probe == "grad_remat":
            def remat(bt):
                for prm in model.parameters():
                    prm.grad = None
                loss = checkpoint(loss_of, cfg, model, bt,
                                  use_reentrant=False)
                loss.backward()
                return loss.detach()
            timed(probe, remat, grad(cfg, plain))
        elif probe == "fp32":
            cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                          dtype="float32"))
            model32 = plain_twin(cfg32, dev)
            timed("fp32 grad", grad(cfg32, model32), grad(cfg32, model32),
                  "float32")
            del model32
    return 0


if __name__ == "__main__":
    sys.exit(main())
