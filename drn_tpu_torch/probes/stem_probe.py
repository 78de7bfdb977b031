"""The stem kernel's one run-time geometry choice, its Cout split (port of
scripts/stem_probe.py).

    python -m drn_tpu_torch.probes.stem_probe        # B=48 and 384
    python -m drn_tpu_torch.probes.stem_probe --device cpu \\
        --config synthetic_tiny --batch-sizes 2 --iters 1      # a rehearsal

The JAX script sweeps its Pallas kernel's batch block × channel chunk.
The port's stem kernel (`ops/cuda/csrc/stem_sm90.cuh`) has its row tile
and k-tile depth compiled in (the C entry point refuses any other) and
its ring depth fixed by each instantiation; the one choice made at run
time is the split of a row tile's 512 Cout columns over a cluster of 2
blocks, which `ops/cuda/stem.py::stem_plan` takes where twice the row
tiles still fit the SMs (split 2 at the eval step's B=48, 48 tiles;
split 1 at the train step's B=384, 384 tiles). This probe forces each
split at both batches. A sweep of the tile geometry would need builds
with other compiled constants, as `probes/stem_parts.py` builds its
variants; it is left out.

At `--config`'s stem (charades_c3d_batched_eval: T=64, F=4096 → D=512,
K=3) with seeded inputs (fp32 features, the LayerNorm parameters, a bf16
weight), per batch size, rows:

  - `plain`: `fused_stem_reference`, the kernel's plain version, the
    reference;
  - `library`: `pallas_model_check.library_stem`, `F.layer_norm`, cuDNN's
    conv, `F.layer_norm` and ReLU, the yardstick;
  - `kernel split=1`, `kernel split=2` (Cout 512 only): the kernel
    launched on `stem_plan(..., split=s)` (`ops/cuda/stem.py::
    launch_stem`), with the plan's grid and stages and the rule's own
    `default_split`. On a CPU tensor the plain version runs instead, as
    every kernel wrapper's does.

Each row: `graph_ms`, the device time a call from a CUDA graph of 20
calls (`utils/profiling.py::cuda_time_ms`: a stem call copies nothing from
the host); `bench.call_row`'s host time a call of a chain of `--iters`
calls (with `clamped`), profiler device time and kernels a call; and its
largest difference from `plain` (`max_abs_err`) with `tol_ratio`, the
largest |diff| / (ATOL + RTOL·|plain|), at most 1 within chip_smoke's
kernel tolerance. One JSON line a row on stdout. Runs on `cuda` unless
`--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

# A kernel against its plain version in bf16 (chip_smoke's `kernels`
# phase): a rounding flip of the output, two bf16 ulps relative plus 1/64
# absolute near 0.
ATOL = RTOL = 1 / 64


def stem_at_split(split: int, x, in_scale, in_bias, w, b, scale, offset):
    """`fused_stem` (LayerNorm and ReLU on) on a plan with the Cout split
    forced to `split`; the plain version on a CPU tensor. The split is
    checked (`stem_plan`) on either device."""
    from drn_tpu_torch.ops.cuda.stem import (H100_SMS, fused_stem_reference,
                                             launch_stem, stem_plan)

    bsz, t, cin = x.shape
    k, _, cout = w.shape
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else H100_SMS)
    plan = stem_plan(bsz * t, cin, cout, k, sms, split=split)
    if x.device.type == "cpu":
        return fused_stem_reference(x, in_scale, in_bias, w, b, scale,
                                    offset)
    return launch_stem(x, in_scale, in_bias, w, b, scale, offset, True, True,
                       plan)


def make_inputs(b: int, t: int, cin: int, cout: int, dev, seed: int = 0):
    """Seeded stem inputs, scaled as chip_smoke's kernel rows: features
    N(0.5, 2²), LayerNorm scales 1 + N(0, 0.1²), offsets and biases
    N(0, 0.1²) (the bias at bf16 values), the weight N(0, 1/(3·cin)) in
    bf16."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, s=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * s).to(dev)
    x = f32(b, t, cin, s=2.0) + 0.5
    in_scale, in_bias = 1.0 + f32(cin, s=0.1), f32(cin, s=0.1)
    w = f32(3, cin, cout, s=1 / math.sqrt(3 * cin)).to(torch.bfloat16)
    bias = f32(cout, s=0.1).to(torch.bfloat16).float()
    scale, offset = 1.0 + f32(cout, s=0.1), f32(cout, s=0.1)
    return x, in_scale, in_bias, w, bias, scale, offset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the stem kernel at each Cout "
                                            "split")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--batch-sizes", default="48,384")
    p.add_argument("--iters", type=int, default=16,
                   help="chained calls per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import call_row, perturb_first, print_row
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import resolve_device
    from drn_tpu_torch.ops.cuda.stem import (H100_SMS, fused_stem_reference,
                                             stem_plan)
    from drn_tpu_torch.probes.pallas_model_check import library_stem
    from drn_tpu_torch.utils.profiling import cuda_time_ms

    dev = resolve_device(args.device)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    cfg = get_config(args.config)
    t, cin, cout = (cfg.data.num_clips, cfg.model.feature_dim,
                    cfg.model.hidden_dim)
    for b in (int(v) for v in args.batch_sizes.split(",")):
        inputs = make_inputs(b, t, cin, cout, dev)
        rows = {"plain": (fused_stem_reference, {}),
                "library": (library_stem, {})}
        for split in (1, 2) if cout == 512 else (1,):
            plan = stem_plan(b * t, cin, cout, 3, sms, split=split)
            rows[f"kernel split={split}"] = (
                lambda *a, s=split: stem_at_split(s, *a),
                {"split": split, "grid": plan.grid, "stages": plan.stages})
        with torch.no_grad():
            want = fused_stem_reference(*inputs).float()
            for name, (fn, extra) in rows.items():
                diff = (fn(*inputs).float() - want).abs()
                print_row({
                    "probe": "stem_probe", "row": name, "B": b, "T": t,
                    "Cin": cin, "Cout": cout, "K": 3,
                    "default_split": stem_plan(b * t, cin, cout, 3, sms).split,
                    **extra,
                    "graph_ms": (cuda_time_ms(lambda: fn(*inputs))
                                 if dev.type == "cuda" else None),
                    "max_abs_err": diff.max().item(),
                    "tol_ratio": (diff / (ATOL + RTOL * want.abs())).max()
                    .item(),
                    **call_row(fn, inputs, args.iters, dev,
                               perturb=perturb_first)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
