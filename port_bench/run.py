"""One run of one cell of the benchmark, from the root of a checkout:

    python3 -X pycache_prefix=port_bench/_pycache -m port_bench \\
        --workload charades.eval_split.b2048 --seed 7 --seconds 20 --trace 0

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (from a profiled window after the measured one). Both
check the outputs against the reference and print each compared number
beside its limit, last on standard error and last in the result line.
The last line of standard output is the result, one JSON object.

Exit codes: 0 with a result; 2 without a usable card; 3 when a module of
JAX or of the JAX package was loaded; anything else is a failure of the
run. None of them but 0 prints a result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

from port_bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "drn_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "port_bench" / "_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `drn_tpu_torch` is not `drn_tpu`)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = spec.ROOT
    cache_env(root)
    bench = spec.benchmark(root)
    cell = spec.workload(bench, args.workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    wanted = [m["name"] for m in spec.metrics_of(bench, cell,
                                                 bool(args.trace))]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"[port_bench] needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from port_bench import harness

    ctx = harness.Ctx(cell=cell, conf=conf, traffic=traffic,
                      limits=spec.limits(cell["name"]), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      t_start=t_start, device=torch.device("cuda", 0))
    res = spec.entry(traffic["entry"]).run(ctx)

    metrics = {}
    if args.trace:
        w = res["window"]
        metrics = {k: {"value": v, "unit": _unit(bench, k)} for k, v in
                   harness.read_metrics(wanted, w).items()}
    else:
        values = {**res["e2e"], "setup_s": ctx.setup_s}
        metrics = {k: {"value": values[k], "unit": _unit(bench, k)}
                   for k in wanted if k in values}
    verdict = harness.judge(res["numbers"], ctx.limits)
    checks = verdict["checks"]
    props = torch.cuda.get_device_properties(0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"],
              "memory_total_bytes": props.total_memory}
    line = {"correct": verdict["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = res["window"].timing
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = tr.breakdown()
    line["setup"] = {"setup_s": ctx.setup_s, **ctx.notes}
    line["info"] = res.get("info", {})
    line["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"[port_bench] JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"[port_bench] check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line), allow_nan=False), flush=True)
    return 0


def finite(x):
    """`x` with every float that is not finite as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _unit(bench: dict, name: str) -> str:
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)
