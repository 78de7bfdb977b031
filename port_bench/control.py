"""The readings that the limits of a cell's comparison are set from, on the
card at the cell's own size, in one process:

    python3 -m port_bench.control --workload charades.eval_split.b2048 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --faults 7,8,9

  --seeds          the program's numbers, a run's set-up and checks with no
                   measured window (one pass, or the checked steps)
  --control-seeds  the control's: the reference computed in fp8 in the
                   program's place (reference/lowp.py)
  --faults         each of faults.py's faults of the cell's entry, planted
                   in the program, on these seeds

One JSON line a reading on standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import faults, gen, harness, run, spec
from port_bench.reference import lowp


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def context(cell, seed: int) -> harness.Ctx:
    return harness.Ctx(cell=cell, conf=spec.config(cell["config"]),
                       traffic=spec.traffic(cell["traffic"]),
                       limits=spec.limits(cell["name"]), seed=seed,
                       seconds=0.0, trace=False,
                       t_start=time.perf_counter(),
                       device=torch.device("cuda", 0))


def program_reading(ctx):
    res = spec.entry(ctx.traffic["entry"]).run(ctx)
    return res["numbers"], res["info"]


def control_reading(ctx, rounding) -> dict:
    """The reference in `rounding`'s precision against the reference, on
    the inputs the cell's run would make from the seed."""
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.models import DRN

    entry = ctx.traffic["entry"]
    cfg = get_config(ctx.conf["registry"])
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  DRN(cfg.model, cfg.data.num_clips).state_dict().items()}
    split = gen.queries(ctx.traffic, ctx.dims, ctx.seed)
    table = gen.table(ctx.traffic, ctx.dims, ctx.seed, ctx.device)
    mod = spec.entry(entry)
    if entry == "eval_split":
        return mod.control(ctx, shapes, split, table, rounding)
    b = ctx.traffic["batch"]
    feed = gen.train_batches(split, b, ctx.seed)
    batches = [next(feed) for _ in range(ctx.traffic["check_steps"])]
    per_epoch = -(-len(split["valid"]) // b)
    ref = mod.reference_steps(ctx, shapes, batches, table, per_epoch)
    low = mod.reference_steps(ctx, shapes, batches, table, per_epoch,
                              rounding)
    return mod.readings(low, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    run.cache_env(spec.ROOT)
    cell = spec.workload(spec.benchmark(), args.workload)
    entry = spec.traffic(cell["traffic"])["entry"]
    harness.build_kernels()
    rows = [("program", None, s) for s in seeds(args.seeds)]
    rows += [("control", None, s) for s in seeds(args.control_seeds)]
    rows += [("fault", f, s) for f in faults.FAULTS[entry]
             for s in seeds(args.faults)]
    for kind, fault, seed in rows:
        ctx = context(cell, seed)
        t0 = time.perf_counter()
        if kind == "program":
            numbers, info = program_reading(ctx)
        elif kind == "control":
            numbers, info = control_reading(ctx, lowp.fp8)
        else:
            with faults.plant(fault, entry):
                numbers, info = program_reading(ctx)
        torch.cuda.empty_cache()
        print(json.dumps(run.finite({
            "workload": cell["name"], "kind": kind, "fault": fault,
            "seed": seed, "numbers": numbers, "info": info,
            "seconds": time.perf_counter() - t0})), flush=True)
    if run.forbidden_modules():
        print(f"loaded: {run.forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
