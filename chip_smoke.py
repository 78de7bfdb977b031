#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (drn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printing one JSON line; the first failure ends the run with a
non-zero exit code:

  1. build    nvcc builds every kernel source of drn_tpu_torch/ops/cuda/csrc
              for sm_90a into the git-ignored build directory.
  2. kernels  each kernel at every distinct shape the flagship eval step
              (charades_c3d_batched_eval, B=48) and train step (B=384:
              forward, the backward's recomputes, the fusion dx convs)
              give it, `fused_fusion` also at B=48 (its splits), and the
              stem at activitynet_c3d's Cin=500 (B=16, T=256) and at
              synthetic_recipe's Cin=256 -> Cout=128 (B=64, T=64), held
              against its plain PyTorch version on the card (bf16
              tolerance below), and timed with CUDA events over a CUDA
              graph of back-to-back launches: the kernel, its plain
              version, and `F.conv1d` of the same conv as a yardstick (the
              port never calls it). Every row also carries its grid
              (`blocks`) and achieved `tflops`; conv_ln_relu's and the
              fusion kernels' also the cluster `split` of its columns.
  3. main     `build_model` + `evaluate()` at the flagship width (D=512,
              F=4096, T=64, 3 levels) on the synthetic fixture, 3 batches of
              48 (the last one ragged); the launch counts of that run; the
              same forward with the kernels' plain versions compared; the
              eval step's queries/s, its matmul + conv FLOPs
              (`utils.flops.estimate_flops`, equal through the kernels and
              through the plain versions) and its share of the card's
              bf16 peak (mfu).
  4. train    the two-stage trainer at the same width with its training
              batch (data.batch_size=384) on one device-resident batch of
              the fixture: 5 stage-1 steps through `make_train_step` (finite,
              falling losses) with the launch counts of those steps; one
              step's loss and every parameter gradient against the same
              step through the kernels' plain versions with autograd; one
              stage-2 (IoU head only) step that moves the IoU head alone;
              the step's time and examples/s, kernels and plain; its FLOPs
              and mfu.
  5. probe    the measurement probe `drn_tpu_torch.probes.pallas_block_probe`
              at its shapes (B=256, T=64, D=512, K=3) with the launch count
              of that run: `pallas_block` against the probe's `xla_block`,
              and the times of the kernel, its plain version and the
              library yardstick (cuDNN conv + layer_norm + ReLU), its grid
              (`blocks`), cluster `split` and achieved `tflops`; then the
              kernel against its plain version at K=3 and at K=4 (B=32).

Then the card's name and power limit (nvidia-smi), one JSON line with every
kernel (its entry source and the header its kernel is built on; its
launches from the `main` run, `fused_fusion`'s from the `train` run,
`pallas_block`'s from the `probe` run), and last {"ok": true, "device":
{...}}.

Without a CUDA device, or run in a directory without the package, it exits
non-zero and prints no result. It imports nothing of JAX nor of `drn_tpu`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from collections import Counter

# H100 SXM data-sheet peaks (dense): the bound of every kernel below.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version in bf16: both multiply bf16 inputs, sum in fp32
# (in another order) and round the output to bf16 once, so they may differ
# by a rounding flip of the output: two bf16 ulps relative (1/64) plus 1/64
# absolute for values near 0.
KERNEL_ATOL = KERNEL_RTOL = 1 / 64
# Whole forward, kernels vs plain versions, both in bf16: the flips above
# pass through ~10 bf16 layers; LayerNorm keeps them at the ulp scale. The
# outputs compared: match/IoU logits, and segments in base-grid units
# (0..64), whose soft-capped exponent turns a logit flip into a relative
# change of the distance.
MAIN_TOL = {"match_logits": (0.05, 0.05), "iou_logits": (0.05, 0.05),
            "segments": (0.25, 0.02)}
# Train step, kernels vs plain versions, both in bf16: the loss within 2%
# relative, each parameter's gradient within 8% relative L2 error. The
# kernels' backward rounds each LayerNorm cotangent to bf16 before the
# conv's VJP (as the JAX package's does) where the plain versions'
# autograd keeps it in fp32: 2^-9 relative per element. A weight's
# gradient sums such products over all B·T rows, and on the fixture's
# noise features the terms mostly cancel, so the sum's relative error is
# many times 2^-9: on an H100 80GB HBM3 at 700 W, 3.9% for the stem's
# weight and 0.3% for the median parameter; 8% leaves room for another
# card's summation order.
TRAIN_LOSS_RTOL = 0.02
TRAIN_GRAD_REL = 0.08

CONFIG = "charades_c3d_batched_eval"
EXAMPLES = 120  # 48 + 48 + 24: three eval steps, the last one padded
TRAIN_BATCH = 384  # the config's data.batch_size, its training batch
TRAIN_STEPS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(cfg, dev):
    """Every kernel at every distinct shape of both main paths: error vs
    its plain version, times, bound. Rows of the eval step (B=48), of the
    train step (B=384: the forward's launches, the backward's recomputes
    of the pre-LayerNorm conv with LayerNorm and ReLU off, each fusion
    level's dx conv), and the stem at activitynet_c3d's Cin=500 and
    synthetic_recipe's Cout=128 (0 per step: coverage). Returns
    ({(path, kernel): totals per step}, rows)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from drn_tpu_torch.models.drn import conv_block_sites
    from drn_tpu_torch.ops.cuda import conv_block, fused_fusion, stem
    from drn_tpu_torch.utils.profiling import cuda_time_ms

    d, kf = cfg.model.hidden_dim, cfg.model.fusion_kernel_size
    t0, fdim = cfg.data.num_clips, cfg.model.feature_dim
    level_ts = [t0 // 2 ** l for l in range(cfg.model.num_levels)]
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev).to(dtype).contiguous()

    def epilogue_params(cout):
        return (randn(cout, scale=0.1).float(),                # bias, bf16 values
                (1.0 + randn(cout, scale=0.1, dtype=torch.float32)),
                randn(cout, scale=0.1, dtype=torch.float32))

    def library_conv(x, w, k, stride):
        """F.conv1d (cuDNN) of the same conv, input pre-laid out (B, C, T)
        with XLA SAME padding: the yardstick, conv only."""
        t = x.shape[1]
        _, left, right = conv_block.same_padding(t, k, stride)
        xt = F.pad(x.transpose(1, 2), (left, right)).contiguous()
        wt = w.permute(2, 1, 0).contiguous()
        return lambda: F.conv1d(xt, wt, stride=stride)

    rows = []

    def measure(path, kernel, shape, count, run, plain, library, flops,
                nbytes):
        with torch.no_grad():
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            lim = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
            if not bool((err <= lim).all()):
                raise AssertionError(
                    f"{kernel} {shape}: max |kernel - plain| "
                    f"{err.max().item():.4g} over the bf16 tolerance")
            bms, by = bound(flops, nbytes)
            rows.append(dict(
                path=path, kernel=kernel, shape=shape, per_step=count,
                max_abs_err=err.max().item(), ms=cuda_time_ms(run),
                plain_ms=cuda_time_ms(plain), library_ms=cuda_time_ms(library),
                bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes))

    def conv_rows(path, b, counts):
        """conv_ln_relu: one row per distinct shape, with its launches per
        step, its grid (`blocks`), the cluster split of its columns and its
        achieved TFLOP/s."""
        for (t, cin, k, stride, use_norm, use_act), n in counts.items():
            x = randn(b, t, cin)
            w = randn(k, cin, d, scale=1 / math.sqrt(k * cin))
            bias, scale, offset = epilogue_params(d)
            args = (x, w, bias, scale, offset, stride, use_norm, use_act)
            t_out = conv_block.same_padding(t, k, stride)[0]
            flops = 2 * b * t_out * k * cin * d
            measure(path, "conv_ln_relu",
                    dict(B=b, T=t, Cin=cin, Cout=d, K=k, stride=stride,
                         use_norm=use_norm, use_act=use_act), n,
                    lambda: conv_block.conv_ln_relu(*args),
                    lambda: conv_block.conv_ln_relu_reference(*args),
                    library_conv(x, w, k, stride), flops,
                    2 * (x.numel() + w.numel() + b * t_out * d)
                    + (12 if use_norm else 4) * d)
            plan = conv_block.conv_plan(b * t_out, d, sms)
            rows[-1].update(blocks=plan.grid, split=plan.split,
                            tflops=flops / rows[-1]["ms"] / 1e9)

    def fusion_rows(path, b, epilogue, count=1):
        """fused_fusion_block (epilogue) or fused_fusion: one launch per
        pyramid level (`count` a step), with the grid (`blocks`), the
        cluster split of its columns and the achieved TFLOP/s (conv_plan,
        as conv_ln_relu)."""
        for t in level_ts:
            v, q = randn(b, t, d), randn(b, d, scale=0.5)
            w = randn(kf, d, d, scale=1 / math.sqrt(kf * d))
            args = (v, q, w, *epilogue_params(d)[:3 if epilogue else 1])
            name = "fused_fusion_block" if epilogue else "fused_fusion"
            vq = (v * q[:, None, :]).contiguous()
            flops = 2 * b * t * kf * d * d
            measure(path, name, dict(B=b, T=t, D=d, K=kf), count,
                    lambda: getattr(fused_fusion, name)(*args),
                    lambda: getattr(fused_fusion, name + "_reference")(*args),
                    library_conv(vq, w, kf, 1), flops,
                    2 * (2 * v.numel() + q.numel() + w.numel())
                    + (12 if epilogue else 4) * d)
            plan = conv_block.conv_plan(b * t, d, sms)
            rows[-1].update(blocks=plan.grid, split=plan.split,
                            tflops=flops / rows[-1]["ms"] / 1e9)

    def stem_row(path, b, t, cin, count, use_norm=True, cout=d, **note):
        """fused_stem on fp32 features; without its output LayerNorm and
        ReLU for the backward's recompute. The row also gets the kernel's
        grid (`blocks`) and its achieved TFLOP/s."""
        x = randn(b, t, cin, scale=2.0, dtype=torch.float32) + 0.5
        in_scale = 1.0 + randn(cin, scale=0.1, dtype=torch.float32)
        in_bias = randn(cin, scale=0.1, dtype=torch.float32)
        w = randn(3, cin, cout, scale=1 / math.sqrt(3 * cin))
        bias, scale, offset = epilogue_params(cout)
        args = (x, in_scale, in_bias, w, bias, scale, offset, torch.bfloat16,
                use_norm, use_norm)
        xn = conv_block.layer_norm(x, in_scale, in_bias).to(torch.bfloat16)
        flops = 2 * b * t * 3 * cin * cout
        measure(path, "fused_stem",
                dict(B=b, T=t, Cin=cin, Cout=cout, K=3, use_norm=use_norm,
                     use_act=use_norm, **note),
                count, lambda: stem.fused_stem(*args),
                lambda: stem.fused_stem_reference(*args),
                library_conv(xn, w, 3, 1), flops,
                4 * x.numel() + 8 * cin + 2 * w.numel() + 2 * b * t * cout
                + (12 if use_norm else 4) * cout)
        rows[-1].update(blocks=stem.stem_plan(b * t, cin, cout, 3, sms).grid,
                        tflops=flops / rows[-1]["ms"] / 1e9)

    fwd = [s[1:] for s in conv_block_sites(cfg.model, t0)]
    b = cfg.eval.batch_size
    conv_rows("eval", b, Counter(fwd))
    fusion_rows("eval", b, True)
    stem_row("eval", b, t0, fdim, 1)

    # The train step: the forward's launches, the backward's recompute of
    # each block (LayerNorm and ReLU off), each fusion level's dx conv.
    recompute = [(t, cin, k, st, False, False) for t, cin, k, st, _, _ in fwd]
    dx = [(t, d, kf, 1, False, False) for t in level_ts]
    conv_rows("train", TRAIN_BATCH, Counter(fwd + recompute + dx))
    fusion_rows("train", TRAIN_BATCH, True)
    fusion_rows("train", TRAIN_BATCH, False)
    stem_row("train", TRAIN_BATCH, t0, fdim, 1)
    stem_row("train", TRAIN_BATCH, t0, fdim, 1, use_norm=False)

    # fused_fusion at the eval batch's splits (it runs in the train step
    # alone); activitynet_c3d's 500 features: a ragged last k-tile of
    # channels; synthetic_recipe's stem, Cin=256 -> Cout=128, at its eval
    # batch.
    fusion_rows("coverage", b, False, 0)
    stem_row("coverage", 16, 256, 500, 0, config="activitynet_c3d")
    stem_row("coverage", 64, 64, 256, 0, cout=128, config="synthetic_recipe")

    totals = {}
    for r in rows:
        tot = totals.setdefault((r["path"], r["kernel"]), Counter())
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += r["per_step"] * r[key]
        tot["bound_" + r["bound_by"]] += r["per_step"] * r["bound_ms"]
        tot["max_abs_err"] = max(tot["max_abs_err"], r["max_abs_err"])
    return totals, rows


def main_path_phase(cfg, dev):
    """evaluate() through the kernels, with the launch counts of that run;
    the same forward through the plain versions; the step's queries/s."""
    import torch

    from drn_tpu_torch.evaluate import (build_model, evaluate, make_eval_step,
                                        to_device)
    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.models.layers import PLAIN_OPS
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from drn_tpu_torch.utils.flops import estimate_flops
    from drn_tpu_torch.utils.profiling import host_ms

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    dataset = make_dataset(cfg.data, cfg.model, split="test")
    setup_s = time.perf_counter() - t0

    steps = -(-len(dataset) // cfg.eval.batch_size)
    m = cfg.model
    per_step = {"fused_stem": 1, "fused_fusion_block": m.num_levels,
                "conv_ln_relu": 3 * m.num_levels + 2 * m.head_tower_layers
                + m.iou_head_layers, "fused_fusion": 0, "pallas_block": 0}
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = evaluate(cfg, model, dataset, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite or empty metrics: {metrics}")

    # The same forward with the kernels' plain versions, same weights.
    batch = to_device(next(BatchIterator(dataset, cfg.eval.batch_size,
                                         shuffle=False).epoch(0)), dev)
    plain = build_model(cfg, device=dev, seed=0, ops=PLAIN_OPS)
    plain.load_state_dict(model.state_dict())
    args = (batch["features"], batch["word_ids"], batch["query_mask"])
    with torch.no_grad():
        got, ref = model(*args), plain(*args)
    errors = {}
    for key, (atol, rtol) in MAIN_TOL.items():
        g, r = got[key].float(), ref[key].float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"main path: non-finite {key}")
        err = (g - r).abs()
        errors[key] = err.max().item()
        if not bool((err <= atol + rtol * r.abs()).all()):
            raise AssertionError(f"main path: {key} kernels vs plain max "
                                 f"|diff| {errors[key]:.4g} over tolerance")

    # The eval step alone on a device-resident batch, host clock around
    # synchronised runs.
    step, plain_step = make_eval_step(cfg, model), make_eval_step(cfg, plain)
    step_ms = host_ms(lambda: step(batch), 20)
    plain_step_ms = host_ms(lambda: plain_step(batch), 20)
    b = cfg.eval.batch_size

    # Matmul + conv FLOPs of one eval step: the kernels report theirs, the
    # plain versions' products are counted by the mode; the two must agree.
    flops, plain_flops = estimate_flops(step, batch), estimate_flops(
        plain_step, batch)
    if flops != plain_flops or not flops > 0:
        raise AssertionError(f"eval step FLOPs through the kernels {flops} "
                             f"vs the plain versions {plain_flops}")
    return launches, dict(
        phase="main", config=cfg.name, dataset="synthetic", examples=len(dataset),
        steps=steps, batch_size=b, launches=launches, metrics=metrics,
        max_abs_err_vs_plain=errors, setup_s=setup_s, evaluate_s=eval_s,
        evaluate_qps=len(dataset) / eval_s, step_ms=step_ms,
        step_qps=b / (step_ms / 1e3), plain_step_ms=plain_step_ms,
        plain_step_qps=b / (plain_step_ms / 1e3), flops_per_step=flops,
        mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        device=torch.cuda.get_device_name(0))


def train_phase(cfg, dev):
    """The trainer's stage-1 steps through the kernels with their launch
    counts, one step's gradients against the plain versions', a stage-2
    step, and the step's time."""
    import torch

    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.evaluate import build_model, to_device
    from drn_tpu_torch.models.layers import PLAIN_OPS
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from drn_tpu_torch.utils.flops import estimate_flops
    from drn_tpu_torch.utils.profiling import host_ms
    from drn_tpu_torch.train import (loss_and_grads, make_optimizer,
                                     make_train_step)

    t0 = time.perf_counter()
    batch = to_device(next(BatchIterator(
        make_dataset(cfg.data, cfg.model, split="train"), TRAIN_BATCH,
        shuffle=False).epoch(0)), dev)
    model = build_model(cfg, device=dev, seed=0).train()
    step = make_train_step(cfg, model, make_optimizer(cfg, 1, model))
    setup_s = time.perf_counter() - t0

    # Forward 1 / L / (3L + 2·towers + IoU mixes); the backward recomputes
    # every pre-LayerNorm conv with the kernels (stem, `fused_fusion` for
    # each fusion level, each conv block) and runs each fusion level's dx
    # conv through `conv_ln_relu`.
    m = cfg.model
    blocks = 3 * m.num_levels + 2 * m.head_tower_layers + m.iou_head_layers
    per_step = {"fused_stem": 2, "fused_fusion_block": m.num_levels,
                "conv_ln_relu": 2 * blocks + m.num_levels,
                "fused_fusion": m.num_levels, "pallas_block": 0}
    reset_launch_counts()
    losses = [step(batch)["loss"].item() for _ in range(TRAIN_STEPS)]
    launches = launch_counts()
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"train launch counts {launches}, expected "
                             f"{want}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"stage-1 losses not finite and falling: "
                             f"{losses}")

    # One step's gradients, kernels vs plain versions, same weights/batch.
    plain = build_model(cfg, device=dev, seed=0, ops=PLAIN_OPS).train()
    plain.load_state_dict(model.state_dict())
    got = loss_and_grads(cfg, model, batch)["loss"].item()
    ref = loss_and_grads(cfg, plain, batch)["loss"].item()
    if abs(got - ref) > TRAIN_LOSS_RTOL * abs(ref):
        raise AssertionError(f"train loss kernels {got} vs plain {ref}")
    plain_params = dict(plain.named_parameters())
    grad_err = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        g, r = p.grad.float(), plain_params[name].grad.float()
        rn = r.norm().item()
        err = (g - r).norm().item() / rn if rn > 0 else g.norm().item()
        grad_err[name] = err
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= TRAIN_GRAD_REL:
        raise AssertionError(f"gradient of {worst}: relative L2 error "
                             f"{grad_err[worst]:.4g} over {TRAIN_GRAD_REL}")

    # One step's matmul + conv FLOPs: forward, the backward's recomputes
    # and conv VJPs, the LSTM's forward and backward (one more step taken).
    flops = estimate_flops(step, batch)
    step_ms = host_ms(lambda: step(batch), TRAIN_STEPS)
    plain_step = make_train_step(cfg, plain, make_optimizer(cfg, 1, plain))
    plain_step_ms = host_ms(lambda: plain_step(batch), 3)

    # Stage 2, IoU head only: nothing else may move.
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, stage=2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stage2_loss = make_train_step(cfg2, model, make_optimizer(cfg2, 1, model))(
        batch)["loss"].item()
    moved = sorted({model.owner(k) for k, v in model.state_dict().items()
                    if not torch.equal(v, before[k])})
    if moved != ["iou_head"] or not math.isfinite(stage2_loss):
        raise AssertionError(f"stage-2 step moved {moved}, loss "
                             f"{stage2_loss}")
    return launches, dict(
        phase="train", config=cfg.name, dataset="synthetic",
        batch_size=TRAIN_BATCH, steps=TRAIN_STEPS, setup_s=setup_s,
        losses=losses, launches=launches,
        launches_per_step={k: n // TRAIN_STEPS for k, n in launches.items()},
        loss_kernels=got, loss_plain=ref,
        max_grad_rel_err={"param": worst, "err": grad_err[worst]},
        median_grad_rel_err=sorted(grad_err.values())[len(grad_err) // 2],
        step_ms=step_ms, examples_per_s=TRAIN_BATCH / (step_ms / 1e3),
        flops_per_step=flops, mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        plain_step_ms=plain_step_ms,
        plain_examples_per_s=TRAIN_BATCH / (plain_step_ms / 1e3),
        stage2_loss=stage2_loss, stage2_moved=moved,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        device=torch.cuda.get_device_name(0))


def probe_phase(dev):
    """The measurement probe (`drn_tpu_torch.probes.pallas_block_probe`)
    at its shapes, with the launch counts of that run; then the kernel
    against its plain version at the probe's K=3 and at an even K (4, one
    row further left than SAME), which no other kernel takes."""
    import torch

    from drn_tpu_torch.ops.cuda import (launch_counts, pallas_block,
                                        pallas_block_reference,
                                        reset_launch_counts)
    from drn_tpu_torch.ops.cuda.conv_block import conv_plan
    from drn_tpu_torch.probes import pallas_block_probe as probe

    reset_launch_counts()
    res = probe.run(dev)
    launches = launch_counts()
    if not launches["pallas_block"] or any(
            n for k, n in launches.items() if k != "pallas_block"):
        raise AssertionError(f"probe launch counts {launches}")

    errors = {}
    for b, k in ((probe.B, probe.K), (32, 4)):
        args = probe.make_inputs(b, probe.T, probe.D, k, dev, seed=1)
        with torch.no_grad():
            got, want = pallas_block(*args).float(), \
                pallas_block_reference(*args).float()
            torch.cuda.synchronize()
        err = (got - want).abs()
        errors[f"B={b},K={k}"] = err.max().item()
        if not bool((err <= KERNEL_ATOL + KERNEL_RTOL * want.abs()).all()):
            raise AssertionError(f"pallas_block B={b} K={k}: max |kernel - "
                                 f"plain| {err.max().item():.4g} over the "
                                 f"bf16 tolerance")
    b, t, d, k = probe.B, probe.T, probe.D, probe.K
    flops = 2 * b * t * k * d * d
    nbytes = 2 * (2 * b * t * d + b * d + k * d * d + d) + 8 * d
    bms, by = bound(flops, nbytes)
    plan = conv_plan(b * t, d, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return launches, dict(
        phase="probe", shape=dict(B=b, T=t, D=d, K=k),
        launches=launches["pallas_block"],
        max_abs_err_vs_plain=errors,
        max_abs_err_vs_xla_block=res["max_abs_err_vs_xla_block"],
        ms=res["ms"], plain_ms=res["plain_ms"],
        xla_block_ms=res["xla_block_ms"], library_ms=res["library_ms"],
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        blocks=plan.grid, split=plan.split, tflops=flops / res["ms"] / 1e9,
        device=res["device"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    import drn_tpu_torch  # noqa: F401  (sets the TF32 switches off)
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda")
    base = get_config(CONFIG)
    cfg = base.replace(data=dataclasses.replace(
        base.data, dataset="synthetic", synthetic_examples=EXAMPLES))

    seconds = _build.build_all()
    emit({"phase": "build", "seconds": seconds,
          "dir": str(_build.build_dir().relative_to(_build.BUILD_ROOT.parents[3])),
          "sources": list(_build.SOURCES)})

    totals, rows = kernel_phase(cfg, dev)
    emit({"phase": "kernel_shapes", "rows": rows,
          "per_step": {f"{path}/{k}": dict(tot)
                       for (path, k), tot in totals.items()}})

    launches, main_line = main_path_phase(cfg, dev)
    emit(main_line)

    train_cfg = base.replace(data=dataclasses.replace(
        base.data, dataset="synthetic", batch_size=TRAIN_BATCH,
        synthetic_examples=TRAIN_BATCH))
    train_launches, train_line = train_phase(train_cfg, dev)
    emit(train_line)
    probe_launches, probe_line = probe_phase(dev)
    emit(probe_line)
    # Each kernel's launches on its main path: the eval step's kernels in
    # the `main` run, `fused_fusion` (backward only) in the `train` run,
    # `pallas_block` in the `probe` run.
    launches["fused_fusion"] = train_launches["fused_fusion"]
    launches["pallas_block"] = probe_launches["pallas_block"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)

    # Each kernel's entry source, the header its kernel is built on, and
    # the TPU kernel it replaces. The fusion kernels and the probe's block
    # are conv_sm90.cuh's Hadamard variant.
    where = {
        "fused_stem": ("drn_tpu_torch/ops/cuda/csrc/stem.cu", "stem_sm90.cuh",
                       "drn_tpu/ops/pallas/stem.py:111"),
        "fused_fusion_block": ("drn_tpu_torch/ops/cuda/csrc/fused_fusion.cu",
                               "conv_sm90.cuh",
                               "drn_tpu/ops/pallas/fused_fusion.py:146"),
        "conv_ln_relu": ("drn_tpu_torch/ops/cuda/csrc/conv_block.cu",
                         "conv_sm90.cuh",
                         "drn_tpu/ops/pallas/conv_block.py:100"),
        "fused_fusion": ("drn_tpu_torch/ops/cuda/csrc/fused_fusion.cu",
                         "conv_sm90.cuh",
                         "drn_tpu/ops/pallas/fused_fusion.py:61"),
        "pallas_block": ("drn_tpu_torch/ops/cuda/csrc/block_probe.cu",
                         "conv_sm90.cuh", "scripts/pallas_block_probe.py:52"),
    }
    # `pallas_block` at the probe's one shape, its own path.
    totals["probe", "pallas_block"] = Counter(
        max_abs_err=max(probe_line["max_abs_err_vs_plain"].values()),
        **{k: probe_line[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms")},
        **{"bound_" + probe_line["bound_by"]: probe_line["bound_ms"]})
    # Per eval step for the eval path's kernels (their first slice), per
    # train step for `fused_fusion`, which runs only there, per call at the
    # probe's shape for `pallas_block`.
    path = {"fused_fusion": "train", "pallas_block": "probe"}
    kernels = []
    for name, (source, header, replaces) in where.items():
        tot = totals[path.get(name, "eval"), name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "header": header,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["bound_operations"]
                         >= tot["bound_bytes"] else "bytes"),
            "library_ms": tot["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
