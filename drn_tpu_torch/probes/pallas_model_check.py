"""The kernels against their plain versions in the whole model (port of
scripts/pallas_model_check.py).

    python -m drn_tpu_torch.probes.pallas_model_check
    python -m drn_tpu_torch.probes.pallas_model_check --device cpu \\
        --config synthetic_tiny --iters 1                     # a rehearsal

One set of seeded random weights (`evaluate.build_model(seed=0)`) and
bench.py's batch (`bench.make_bench_batch`) at `--config`
(charades_c3d_batched_eval, B=48). Each variant is the model built with
another `Ops` tuple (`models/layers.py`), the port's counterpart of the
JAX package's `use_pallas_*` flags:

  - `plain`: `PLAIN_OPS`, the kernels' plain versions, the reference;
  - `library`: `LIBRARY_OPS`, defined here: each function through
    PyTorch's library calls (cuDNN `F.conv1d` of the SAME-padded input,
    the bias added in fp32, `F.layer_norm`, ReLU). The JAX script's "xla"
    row; a timing yardstick only, which the port calls nowhere else;
  - `stem`, `fusion`, `conv_blocks`: one kernel (`fused_stem`,
    `fused_fusion_block`, `conv_ln_relu`, the config's
    `use_pallas_{stem,fusion,conv_blocks}`), the others plain;
  - `stem+fusion`: those two kernels, the conv blocks plain;
  - `all`: `KERNEL_OPS`, the port's main path.

Per variant one JSON line on stdout: `max_abs_diff`, each forward output's
largest difference from `plain`'s, and `tol_ratio`, the largest of
|diff| / (atol + rtol·|plain|) over the outputs `TOL` bounds (at most 1
within it); the eval step (`evaluate.
make_eval_step`) by `bench.call_row` (`host_ms` a step of a chain of
`--iters`, with `clamped`, `qps` from it; `device_ms`, `device_busy_ms`
and `kernels_per_call` from a profiler trace); and `launches`, the package
kernels' launches of one step, beside `expected_launches`, what the
variant's `Ops` launch on the card (1 stem, 1 fusion a level, 3 conv
blocks a level + the head towers + the IoU mixes when all are on; none
off the card, where every wrapper runs its plain version). Runs on `cuda`
unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from drn_tpu_torch.models.layers import KERNEL_OPS, LN_EPS, PLAIN_OPS, Ops
from drn_tpu_torch.ops.cuda.conv_block import same_padding


def library_conv_ln_relu(x, w, b, scale, offset, stride: int = 1,
                         use_norm: bool = True, use_act: bool = True):
    """`conv_ln_relu` by library calls: cuDNN's conv of the SAME-padded
    (B, Cin, T) input with the (Cout, Cin, K) weight, + b in fp32,
    `F.layer_norm`, ReLU; output in x's dtype."""
    k, _, cout = w.shape
    _, left, right = same_padding(x.shape[1], k, stride)
    y = F.conv1d(F.pad(x.transpose(1, 2), (left, right)),
                 w.permute(2, 1, 0), stride=stride)
    y = y.transpose(1, 2).float() + b.float()
    if use_norm:
        y = F.layer_norm(y, (cout,), scale, offset, LN_EPS)
    if use_act:
        y = torch.relu(y)
    return y.to(x.dtype)


def library_fusion_block(v, q, w, b, scale, offset):
    """`fused_fusion_block` by library calls: v ⊙ q in v's dtype, then
    `library_conv_ln_relu`."""
    return library_conv_ln_relu(v * q[:, None, :].to(v.dtype), w, b, scale,
                                offset)


def library_stem(x, in_scale, in_bias, w, b, out_scale, out_bias,
                 cdtype=torch.bfloat16, use_norm: bool = True,
                 use_act: bool = True):
    """`fused_stem` by library calls: `F.layer_norm` over the features in
    fp32, cast to `cdtype`, then `library_conv_ln_relu`."""
    xn = F.layer_norm(x.float(), (x.shape[-1],), in_scale, in_bias,
                      LN_EPS).to(cdtype)
    return library_conv_ln_relu(xn, w.to(cdtype), b, out_scale, out_bias, 1,
                                use_norm, use_act)


# A whole forward against `plain` in bf16 (atol, rtol by output): each
# kernel's output may differ from its plain version by a bf16 rounding
# flip, carried through ~10 layers that LayerNorm keeps at the ulp scale;
# segments in base-grid units, whose soft-capped exponent turns a logit
# flip into a relative change of a distance. chip_smoke's `main` phase
# holds the kernels' forward to the same bounds.
TOL = {"match_logits": (0.05, 0.05), "iou_logits": (0.05, 0.05),
       "segments": (0.25, 0.02)}

LIBRARY_OPS = Ops(library_conv_ln_relu, library_fusion_block, library_stem)

VARIANTS = {
    "plain": PLAIN_OPS,
    "library": LIBRARY_OPS,
    "stem": PLAIN_OPS._replace(fused_stem=KERNEL_OPS.fused_stem),
    "fusion": PLAIN_OPS._replace(
        fused_fusion_block=KERNEL_OPS.fused_fusion_block),
    "conv_blocks": PLAIN_OPS._replace(conv_ln_relu=KERNEL_OPS.conv_ln_relu),
    "stem+fusion": PLAIN_OPS._replace(
        fused_stem=KERNEL_OPS.fused_stem,
        fused_fusion_block=KERNEL_OPS.fused_fusion_block),
    "all": KERNEL_OPS,
}


def expected_launches(ops: Ops, m, dev: torch.device) -> dict:
    """The package kernels' launches of one eval step of a model built
    with `ops` on `dev`: a kernel's count where `ops` holds it and the
    step runs on the card, else 0."""
    per_step = {"fused_stem": 1, "fused_fusion_block": m.num_levels,
                "conv_ln_relu": 3 * m.num_levels + 2 * m.head_tower_layers
                + m.iou_head_layers, "fused_fusion": 0, "pallas_block": 0,
                "conv_ln_relu_bwd": 0, "fused_fusion_block_bwd": 0,
                "map_epilogue": 0}
    on = {k for k in Ops._fields if getattr(ops, k) is getattr(KERNEL_OPS, k)}
    return {k: n if dev.type == "cuda" and k in on else 0
            for k, n in per_step.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the kernels in the whole "
                                            "model, one by one")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--iters", type=int, default=12,
                   help="chained eval steps per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import (call_row, make_bench_batch,
                                     perturb_features, print_row)
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import (build_model, make_eval_step,
                                        resolve_device)
    from drn_tpu_torch.ops.cuda import launch_counts

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    batch = make_bench_batch(cfg, device=dev)
    inputs = (batch["features"], batch["word_ids"], batch["query_mask"])
    b = cfg.eval.batch_size
    ref = None
    for name, ops in VARIANTS.items():
        model = build_model(cfg, device=dev, seed=0, ops=ops)
        with torch.no_grad():
            out = {k: v.float() for k, v in model(*inputs).items()}
        if ref is None:
            ref = out
        step = make_eval_step(cfg, model)
        before = launch_counts()
        step(batch)
        launches = {k: n - before[k] for k, n in launch_counts().items()}
        rec = call_row(step, (batch,), args.iters, dev,
                       perturb=perturb_features)
        print_row({
            "probe": "pallas_model_check", "config": cfg.name,
            "batch_size": b, "row": name,
            "max_abs_diff": {k: (v - ref[k]).abs().max().item()
                             for k, v in out.items()},
            "tol_ratio": {k: ((out[k] - ref[k]).abs() / (
                atol + rtol * ref[k].abs())).max().item()
                for k, (atol, rtol) in TOL.items()},
            **rec, "qps": b / rec["host_ms"] * 1e3, "launches": launches,
            "expected_launches": expected_launches(ops, cfg.model, dev)})
        del model, step
    return 0


if __name__ == "__main__":
    sys.exit(main())
