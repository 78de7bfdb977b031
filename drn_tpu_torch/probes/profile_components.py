"""The eval step split into its components (port of
scripts/profile_components.py).

    python -m drn_tpu_torch.probes.profile_components [--config ...]
    python -m drn_tpu_torch.probes.profile_components --device cpu \\
        --config synthetic_tiny --iters 1                     # a rehearsal

At `--config`'s width (charades_c3d_batched_eval) with seeded random
weights (`evaluate.build_model(seed=0)`) and bench.py's batch
(`bench.make_bench_batch`) at the config's eval batch, one row each:

  - `eval_step`: `evaluate.make_eval_step`, chained as the bench's eval
    chain is, through the features alone;
  - `model_forward`: the model alone, no gradient;
  - `query_encoder`: the encoder alone, chained through
    `query_mask & (s < 1e9)` as the script does, since it reads no
    features;
  - `backbone`: the stem and the level blocks alone;
  - `residual` = model_forward − query_encoder − backbone (fusion, FPN,
    heads, IoU head) and `postproc` = eval_step − model_forward (scoring,
    top-k, NMS, recall), derived from the rows above, host and device.

Each measured row (`bench.call_row`): the host clock's time a call of a
chain of `--iters` calls, with `clamped`; the device time a call from a
profiler trace (the kernels summed, and their union), and the kernels a
call. In eager PyTorch the host row of a small module counts mostly its
launches: the split of host and device time is the finding. A derived row
is `clamped` when one of its terms is. One JSON line a row on stdout.
Runs on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys

import torch

UNITS = ("host_ms", "device_ms", "device_busy_ms", "kernels_per_call")


def derived(name: str, plus: dict, minus) -> dict:
    """`plus` less each row of `minus`, key by key (None off the card)."""
    rec = {"row": name, "derived": True,
           "clamped": plus["clamped"] or any(m["clamped"] for m in minus)}
    for k in UNITS:
        vals = [plus[k]] + [m[k] for m in minus]
        rec[k] = None if None in vals else vals[0] - sum(vals[1:])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the eval step, component by "
                                            "component")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--iters", type=int, default=12,
                   help="chained calls per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import (call_row, make_bench_batch,
                                     perturb_features, perturb_floats,
                                     print_row)
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import (build_model, make_eval_step,
                                        resolve_device)

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    batch = make_bench_batch(cfg, device=dev)
    model = build_model(cfg, device=dev, seed=0)
    step = make_eval_step(cfg, model)
    feats, ids, mask = batch["features"], batch["word_ids"], \
        batch["query_mask"]

    def through_mask(a, s):
        return a[0], a[1] & (s < 1e9)

    @torch.no_grad()
    def no_grad(fn, *a):
        return fn(*a)

    rows = {}
    for name, fn, fargs, perturb in (
            ("eval_step", step, (batch,), perturb_features),
            ("model_forward", model, (feats, ids, mask), perturb_floats),
            ("query_encoder", model.query_encoder, (ids, mask),
             through_mask),
            ("backbone", model.backbone, (feats,), perturb_floats)):
        rows[name] = {"row": name, **call_row(
            lambda *a, fn=fn: no_grad(fn, *a), fargs, args.iters, dev,
            perturb=perturb)}
    rows["residual"] = derived("residual", rows["model_forward"],
                               (rows["query_encoder"], rows["backbone"]))
    rows["postproc"] = derived("postproc", rows["eval_step"],
                               (rows["model_forward"],))
    for rec in rows.values():
        print_row({"probe": "profile_components", "config": cfg.name,
                   "batch_size": cfg.eval.batch_size, **rec})
    return 0


if __name__ == "__main__":
    sys.exit(main())
