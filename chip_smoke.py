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
  6. dataset  the real-dataset path on a Charades-STA corpus written from a
              seed into a temporary directory (128 videos of 1 to 200 rows
              at F=4096, some float16, one of exactly 64 rows; 3 queries
              each: 384 train examples, the first 40 videos' 120 the test
              split; a 300-d GloVe file that lacks a few corpus words);
              the native reader built by g++ (timed, before the runs);
              `evaluate` at the flagship width streamed through the
              FeatureReader and with device_features=True, equal metrics
              and the `main` launch counts for each; the native reader
              serving every .npy; the first batch against NumPy's
              resample of np.load, and the staged gather on the card
              against it. Then `train` in GloVe mode with
              device_features=True at data.batch_size=384 for 2 stage-1
              steps (finite losses, the embedding bit-identical, every
              other parameter outside the IoU head moved, `fused_fusion`
              launched), the staged train step's time, and `infer.main` on
              one written video with the eval model's weights (--top
              segments per query inside [0, duration]).
  7. serve    the batched HTTP server (`drn_tpu_torch.serve`) at the
              flagship width (B=48) on 127.0.0.1, seeded weights read from
              a .pth, the `dataset` phase's corpus (written again from its
              seed) staged in host RAM (`--stage-corpus`): 8 `video_id`
              requests, one `features_path` and one inline `features`
              request (a 5-row video), sent one at a time, each answer
              equal bit for bit to `evaluate.predict` on the padded batch
              the service builds for it (one live row, 47 padding rows);
              the batcher thread's launches, 1 / 3 / 15 a batch as in
              `main` (nothing else touches the card meanwhile); one
              request's batch path without HTTP (the padded batch, its
              copy to the card, the whole `predict`; ms, synchronised);
              then `probes.serve_load` at concurrency 1, 16 and 64 with
              max_wait_ms=5 (q/s, p50/p95 ms, mean batch fill; no error).
  8. export   `probes.export_roundtrip`: the flagship eval step exported
              on the card (`export.export_eval_step`, B=48), its graph
              holding one custom-op node a kernel launch (1 / 3 / 15) and
              no convolution but the heads' three output convs (Cout 2, 1,
              1, left to cuDNN as the JAX package leaves them to XLA);
              a fresh interpreter loads it with `load_exported` alone and
              reproduces the live step bit for bit, with the exported
              weights and with a second seed's passed as `params`; the
              live step's and the artifact's host-clock step times, in
              turns in this process.
  9. checkpoint  checkpoint directories end to end on the `dataset`
              phase's corpus (written again from its seed) at
              charades_c3d's full width in GloVe mode, B=48 (8 steps an
              epoch), streamed: three children of the train CLI on the
              card, 10 steps each: (a) fed in process; (b) fed by 2
              worker processes, sent SIGTERM after its step-3 line, which
              must exit 75 with the step it logged as preempted saved;
              (c) the same command again, which must resume there, exit 0
              and log (a)'s losses within TRAIN_LOSS_RTOL and end on
              (a)'s parameters within RESUME_PARAM_REL (relative L2). (a)
              and (c) cross the first epoch's end: its val eval (test
              split) and best checkpoint. From the children's step lines:
              the train step's ms and examples/s in process (a) and by 2
              workers (c), the epoch boundary's ms; the seconds from (c)'s
              start to its first step and each child's wall time. Then
              the readers of (a)'s directory against its step files:
              `evaluate` (best/ against best/8.pth; --latest-checkpoint
              against 10.pth: the same printouts), `serve.build_service`
              (bit-equal answers to best/8.pth's), `export` (the latest:
              outputs bit-equal to 10.pth's) and `infer` (the same top
              segments as best/8.pth's). Every child launches the four
              package kernels (each prints its launch counts).
 10. ddp      data parallel (parallel/mesh.py, the trainer's DDP path)
              on the one card: (a) the train CLI with `--distributed`
              through the launcher users run (`python -m
              torch.distributed.run --standalone --nproc_per_node=1`), a
              process group of one over NCCL, with the `checkpoint`
              phase's child (a)'s arguments on the corpus written again
              from its seed: its losses against that child's (world size
              1: equal, within TRAIN_LOSS_RTOL), the four package kernels
              launched, and the step ms of both from their step lines;
              (b) two ranks on the card over gloo (NCCL refuses two ranks
              on one device), spawned with torch.multiprocessing, each
              calling `train(mesh=make_mesh())` on the flagship model at
              B=384 (192 rows a rank) on the synthetic fixture, 3 steps,
              the second batch ragged (rank 0 holds 192 valid rows, rank
              1 24): the global losses within TRAIN_LOSS_RTOL of one
              process's `train()` at B=384 from the same seed, every
              kernel launched on each rank; then `evaluate(mesh=...)` on
              both ranks of rank 0's checkpoint (the last batch's block of
              rank 1 is padding alone): equal metrics on both, within one
              query of one process evaluating the same checkpoint. Step
              times are records beside the card's name, not claims.
 11. bench    the port's benchmark as users run it, `python -m
              drn_tpu_torch.bench` in a child process (bench.py's method:
              chained data-dependent steps, one host sync a chain):
              `--iters BENCH_ITERS` (eval q/s at B=48, mfu, the train
              step's examples/s and mfu at B=384, vs_baseline against the
              PyTorch-CPU reference), then `--latency` (B=1) and
              `--all-configs --skip-train --skip-torch` (bench.py's five
              configs); every stdout line a contract line with bench.py's
              keys, every number positive and finite, no per-step time
              that `chained_time` clamped, and each run's launch counts
              (its stderr line) equal to the launches a step of each path
              times the steps it reports. Its line puts the
              contract numbers beside the `main` phase's step_qps and the
              card's name and power limit.
 12. probes   the probes of the host path and the train step, in this
              process: `probes.host_pipeline` (its own corpus, written by
              its `build_corpus` at the dataset phase's size: 128 videos,
              3 queries each, 96-160 rows at F=4096; BatchIterator native
              and NumPy, 2 workers; the eval rate measured on the card) and
              `probes.staged_eval` (streamed and staged `evaluate()` on such
              a corpus: equal metrics, or it raises; the launches of every
              step it ran), then `probes.train_probe` (the train step's
              rows with their FLOPs and mfu) and `probes.train_mfu` (its
              own probes: adam, grad_remat, fp32; the others time
              train_probe's rows again) at B=384 with 12-step chains;
              each probe's rows, none clamped, the package kernels
              launched.
 13. module_probes  the module probes, in this process, chains of
              MODULE_ITERS: `probes.nms_probe` (the single-query sweep
              vmapped and the package's batched sweep, B=48, K=48, random
              and chain inputs: equal order, keep and segments),
              `profile_components` (the eval step, forward, query encoder,
              backbone; residual and postproc derived) at the flagship,
              `profile_residual` (fusion, FPN, heads, IoU head, its
              sampling) at the flagship and at tacos_c3d, `iou_mix_probe`
              at tacos_c3d (A, the port's IoU head, against B, mix_0
              folded through the sampling: relative difference within
              IOU_MIX_REL_TOL), `sample_probe` flat (B=384, N=T=112,
              D=512) and per level at tacos_c3d (each sampler against the
              gather within the tolerance it states), `embed_probe`
              (B=384, L=20, V=8000, D=300: the scatter and the one-hot
              matmul gradients within its fp32 tolerance), `stem_probe`
              (the kernel at split 1 and 2, B=48 and 384, against its
              plain version within the `kernels` tolerance) and
              `pallas_model_check` (the flagship eval step through seven
              `Ops` variants, each forward against the plain versions'
              within the `main` tolerance, each variant's launches a step
              those of its `Ops`): every row with host ms (none clamped),
              device ms from a profiler trace and kernels a call.
 14. recipe   the two-stage recipe probes, in a child interpreter
              (`RECIPE_CHILD`), in one temporary workdir so that one
              stage 1 serves them all:
              `probes.recipe_demo` at synthetic_recipe, 1 epoch a stage,
              seed 0, with tests/test_recipe.py's gates (the trained
              rescore above stage 1 and above the untrained rescore by
              more than 1.0 R@1-mean, above stage 1 by more than 1.0 at
              R@1,IoU=0.7; stage 2 without rescore equal to stage 1 within
              1e-3 on every metric) and stage 2's non-IoU parameters
              bit-identical to stage 1's best; then on its stage 1
              `recipe_untrained_rescore_probe` (2 seeds),
              `recipe_treatment_seeds` (2 seeds, 1 stage-2 epoch) and
              `stage2_regime_ab` (1 seed, 1 stage-2 epoch), each to its
              summary; `atscale_synthetic` at its defaults (charades_c3d's
              width, 512 / 128 examples, B=64, 60 + 40 epochs), whose
              freeze and lift checks raise; `int8_probe` at its shape
              (3072, 12288) x (12288, 512): the int32 accumulators equal
              to the same int8 operands multiplied in float64, every row
              within its type's error bound. The four package kernels
              launched over the runs, `fused_fusion` in stage 1's
              backward, and no kernel's plain version called
              (`plain_calls`). The line: each gate's numbers, seconds a
              module and a stage, peak device memory.

Then the card's name and power limit (nvidia-smi), one JSON line with every
kernel (its entry source and the header its kernel is built on; its
launches from the `main` run, `fused_fusion`'s from the `train` run,
`pallas_block`'s from the `probe` run), and last {"ok": true, "device":
{...}}.

Without a CUDA device, or run in a directory without the package, it exits
non-zero and prints no result. It imports nothing of JAX nor of `drn_tpu`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# A resumed run against the uninterrupted one: the same batches from the
# same state, so only the order of the card's floating-point sums may
# differ (cuDNN's LSTM backward is not bit-deterministic); Adam's first
# steps move each weight by about lr, so after 2 or 3 steps the relative
# L2 distance of all parameters stays far below 1e-3.
RESUME_PARAM_REL = 1e-3
# The checkpoint phase: training batch (8 steps an epoch of the corpus's
# 384 examples), steps (past the first epoch's end and its eval), the step
# after which (b) is sent SIGTERM.
CK_BATCH, CK_STEPS, CK_SIGTERM_AFTER = 48, 10, 3
# The ddp phase's part (b): ranks, global batch, steps, and the fixture's
# size (two batches an epoch, the second of 216 rows: 192 on rank 0 and 24
# on rank 1; its test split's last eval batch of 24 rows is all rank 0's).
DDP_RANKS, DDP_BATCH, DDP_STEPS, DDP_EXAMPLES = 2, 384, 3, 600

CONFIG = "charades_c3d_batched_eval"
EXAMPLES = 120  # 48 + 48 + 24: three eval steps, the last one padded
TRAIN_BATCH = 384  # the config's data.batch_size, its training batch
TRAIN_STEPS = 5

# The dataset phase's corpus: Charades-STA format, C3D width.
DS_VIDEOS, DS_QUERIES, DS_TEST_VIDEOS = 128, 3, 40
DS_FPS = 2.0  # feature rows per second of video
DS_FLOAT16 = (2, 5, 11)  # videos stored as float16 (all in the first batch)
DS_WORDS = (
    "person opens closes the a door window cabinet refrigerator drawer box "
    "laptop phone book bag towel shoes clothes dishes food sandwich cup "
    "glass bottle table chair bed sofa floor mirror light picture pillow "
    "blanket broom vacuum camera paper homework takes puts holds sits "
    "stands walks runs laughs smiles sneezes eats drinks pours washes "
    "dresses undresses watches reads writes tidies throws into on off "
    "from at their his her then").split()
DS_NOT_IN_GLOVE = {"sneezes", "undresses", "tidies", "vacuum"}  # → UNK

# The serve phase: requests, and the load probe's concurrencies and window.
SERVE_VIDEO_IDS = 8
SERVE_CONCURRENCY = (1, 16, 64)
SERVE_LOAD_S = 3.0

# The bench phase's chains: `--iters` of the throughput run (the train chain
# takes half), of `--latency`, of `--all-configs`. At least 12 steps each:
# the host clock moves by more than a step over shorter chains.
BENCH_ITERS, LATENCY_ITERS, ALL_CONFIGS_ITERS = 24, 32, 12
CONTRACT_KEYS = ["metric", "value", "unit", "vs_baseline", "mfu",
                 "train_examples_per_sec", "train_mfu", "iters"]
# The probes phase: the host path's corpus (the dataset phase's size), the
# chains of the train-step probes.
PROBE_CORPUS = ["--videos", str(DS_VIDEOS), "--rows", "96,160",
                "--queries-per-video", str(DS_QUERIES)]
PROBE_ITERS = 12
# The module_probes phase: the chains, and the IoU mix probe's bound on A
# against B (the JAX script's bf16 order tolerance, ~1e-2, doubled).
MODULE_ITERS = 12
IOU_MIX_REL_TOL = 2e-2
# The recipe phase's config (the demo's, and its stage 1 for the other
# recipe probes).
RECIPE_CONFIG = "synthetic_recipe"


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


def eval_launches_per_step(m):
    """Kernel launches of one eval step: the stem, one fusion block a
    level, 3 conv blocks a level (backbone, lateral, smooth), the two head
    towers and the IoU head's mixes."""
    return {"fused_stem": 1, "fused_fusion_block": m.num_levels,
            "conv_ln_relu": 3 * m.num_levels + 2 * m.head_tower_layers
            + m.iou_head_layers, "fused_fusion": 0, "pallas_block": 0}


def train_launches_per_step(m):
    """Forward 1 / L / (3L + 2·towers + IoU mixes); the backward recomputes
    every pre-LayerNorm conv with the kernels (stem, `fused_fusion` for
    each fusion level, each conv block) and runs each fusion level's dx
    conv through `conv_ln_relu`."""
    blocks = 3 * m.num_levels + 2 * m.head_tower_layers + m.iou_head_layers
    return {"fused_stem": 2, "fused_fusion_block": m.num_levels,
            "conv_ln_relu": 2 * blocks + m.num_levels,
            "fused_fusion": m.num_levels, "pallas_block": 0}


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
    per_step = eval_launches_per_step(cfg.model)
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

    per_step = train_launches_per_step(cfg.model)
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


def write_corpus(root, fdim):
    """The dataset phase's Charades-STA corpus under `root`, from a seeded
    generator: one `{video}.npy` a video (1 to 200 rows; video 0 exactly
    the 64-row grid, video 1 one row, DS_FLOAT16 in float16), the
    `charades_sta_{train,test}.txt` annotations (start and end in seconds
    inside rows / DS_FPS) and a 300-d `glove.txt` of every corpus word but
    DS_NOT_IN_GLOVE, plus words the corpus lacks. Returns the DataConfig
    fields that point at it."""
    import numpy as np

    rng = np.random.default_rng(9)
    fd = os.path.join(root, "features")
    os.mkdir(fd)
    lines = []
    for v in range(DS_VIDEOS):
        t = 64 if v == 0 else 1 if v == 1 else int(rng.integers(1, 201))
        feats = rng.standard_normal((t, fdim), dtype=np.float32)
        np.save(os.path.join(fd, f"V{v:04d}.npy"),
                feats.astype(np.float16) if v in DS_FLOAT16 else feats)
        dur = t / DS_FPS
        for _ in range(DS_QUERIES):
            start = float(rng.uniform(0.0, 0.8 * dur))
            end = min(dur, start + float(rng.uniform(0.1, 0.5)) * dur + 0.25)
            words = rng.choice(DS_WORDS, int(rng.integers(4, 11)))
            lines.append(f"V{v:04d} {start:.1f} {end:.1f}##"
                         f"{' '.join(words).capitalize()}.\n")
    with open(os.path.join(root, "charades_sta_train.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(root, "charades_sta_test.txt"), "w") as f:
        f.writelines(lines[:DS_TEST_VIDEOS * DS_QUERIES])
    with open(os.path.join(root, "glove.txt"), "w") as f:
        for w in sorted(set(DS_WORDS) - DS_NOT_IN_GLOVE) + [
                "unused", "extra", "words"]:
            vec = rng.standard_normal(300).astype(np.float32) * 0.4
            f.write(w + " " + " ".join(f"{x:.5f}" for x in vec) + "\n")
    return dict(dataset="charades", feature_dir=fd, feature_fps=DS_FPS,
                annotation_path=os.path.join(root, "charades_sta_{split}.txt"),
                glove_path=os.path.join(root, "glove.txt"))


class _Tee(io.TextIOBase):
    """Writes through to `out` and keeps what it wrote."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def dataset_phase(base, dev):
    """The real-dataset path: evaluate streamed and staged, GloVe-mode
    train with a staged table, infer; see the module's docstring."""
    import numpy as np
    import torch

    from drn_tpu_torch import infer, native
    from drn_tpu_torch.data.features import resample_features
    from drn_tpu_torch.data.pipeline import (BatchIterator, build_vocab,
                                             make_dataset)
    from drn_tpu_torch.data.vocab import UNK_ID, tokenize
    from drn_tpu_torch.evaluate import (batch_features, build_model, evaluate,
                                        stage_on_device, to_device)
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from drn_tpu_torch.train import make_optimizer, make_train_step, train
    from drn_tpu_torch.utils.profiling import host_ms

    with tempfile.TemporaryDirectory(prefix="drn_corpus_") as root:
        t0 = time.perf_counter()
        fields = write_corpus(root, base.model.feature_dim)
        corpus_s = time.perf_counter() - t0
        corpus_bytes = sum(e.stat().st_size for e in
                           os.scandir(fields["feature_dir"]))
        # The native reader's g++ build, before the timed runs.
        t0 = time.perf_counter()
        if native.load() is None:
            raise AssertionError("the native feature reader did not build")
        native_build_s = time.perf_counter() - t0
        hashed = {k: v for k, v in fields.items() if k != "glove_path"}
        cfg = base.replace(data=dataclasses.replace(base.data, **hashed))

        # evaluate(), streamed through the FeatureReader, then staged.
        model = build_model(cfg, device=dev, seed=0)
        steps = -(-DS_TEST_VIDEOS * DS_QUERIES // cfg.eval.batch_size)
        want = {k: n * steps for k, n in
                eval_launches_per_step(cfg.model).items()}
        runs = {}
        for staged in (False, True):
            ds = make_dataset(cfg.data, cfg.model, split="test")
            reset_launch_counts()
            t0 = time.perf_counter()
            metrics = evaluate(cfg, model, ds, device=dev,
                               device_features=staged)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = launch_counts()
            if launches != want:
                raise AssertionError(f"dataset eval (staged={staged}) launch "
                                     f"counts {launches}, expected {want}")
            r = ds.reader
            if r.native_reads != r.cache_misses or r.native_reads != \
                    DS_TEST_VIDEOS:
                raise AssertionError(
                    f"native reads {r.native_reads} of {r.cache_misses} "
                    f"uncached reads, {DS_TEST_VIDEOS} videos")
            runs["staged" if staged else "streamed"] = dict(
                ds=ds, metrics=metrics, s=sec, launches=launches,
                cache_hits=r.cache_hits, cache_misses=r.cache_misses,
                native_reads=r.native_reads)
        if runs["streamed"]["metrics"] != runs["staged"]["metrics"]:
            raise AssertionError(f"streamed {runs['streamed']['metrics']} vs "
                                 f"staged {runs['staged']['metrics']}")
        if not all(math.isfinite(v) for v in
                   runs["streamed"]["metrics"].values()):
            raise AssertionError("non-finite dataset metrics")

        # The first batch: the reader against NumPy, the staged gather on
        # the card against the reader.
        ds = runs["streamed"]["ds"]
        first = next(BatchIterator(ds, cfg.eval.batch_size,
                                   shuffle=False).epoch(0))
        read_err = {"float32": 0.0, "float16": 0.0}
        for i in range(cfg.eval.batch_size):
            vid = ds.examples[i].video_id
            raw = np.load(os.path.join(fields["feature_dir"], f"{vid}.npy"))
            err = float(np.abs(first["features"][i] - resample_features(
                raw, cfg.data.num_clips)).max())
            key = raw.dtype.name
            read_err[key] = max(read_err[key], err)
        if read_err["float32"] > 1e-6 or read_err["float16"] > 1e-3:
            raise AssertionError(f"first batch vs NumPy: {read_err}")
        table, view = stage_on_device(runs["staged"]["ds"], dev)
        light = next(BatchIterator(view, cfg.eval.batch_size,
                                   shuffle=False).epoch(0))
        gathered = batch_features(to_device(light, dev), table)
        if not torch.equal(gathered.cpu(),
                           torch.from_numpy(first["features"])):
            raise AssertionError("staged gather != streamed first batch")
        eval_table_bytes = table.numel() * table.element_size()
        del table, gathered

        # train(): GloVe mode, staged, B=384, two stage-1 steps.
        tcfg = base.replace(
            data=dataclasses.replace(base.data, **fields,
                                     batch_size=TRAIN_BATCH),
            train=dataclasses.replace(
                base.train, checkpoint_dir=os.path.join(root, "ckpt"),
                eval_every_epochs=0, log_every_steps=1))
        vocab = build_vocab(tcfg.data, tcfg.model)
        unk = sum(vocab.lookup(w) == UNK_ID for ex in make_dataset(
            tcfg.data, tcfg.model, vocab, split="train").examples
                  for w in tokenize(ex.sentence))
        init = build_model(tcfg, device="cpu", seed=tcfg.train.seed,
                           pretrained_embeddings=vocab.embeddings
                           ).state_dict()
        tee = _Tee(sys.stderr)
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(tee):
            tmodel = train(tcfg, device=dev, max_steps=2,
                           device_features=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = launch_counts()
        want = {k: 2 * n for k, n in
                train_launches_per_step(tcfg.model).items()}
        if train_launches != want:
            raise AssertionError(f"dataset train launch counts "
                                 f"{train_launches}, expected {want}")
        losses = [rec["loss"] for rec in map(json.loads, (
            ln for ln in "".join(tee.text).splitlines() if ln.startswith("{")))
                  if rec.get("tag", "").startswith("train/") and "loss" in rec]
        if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"dataset train losses {losses}")
        sd = tmodel.state_dict()
        if not torch.equal(sd["embed.weight"].cpu(),
                           torch.from_numpy(vocab.embeddings)):
            raise AssertionError("GloVe embedding moved")
        # The stage-1 loss weighs the IoU head's term by 0: its gradient
        # is 0 and Adam leaves it; the LSTMs' second biases are constants.
        still = sorted(k for k, v in sd.items()
                       if torch.equal(v.cpu(), init[k]) and k != "embed.weight"
                       and tmodel.owner(k) != "iou_head"
                       and not k.endswith(".bias_hh_l0"))
        if still:
            raise AssertionError(f"trained parameters that did not move: "
                                 f"{still[:5]}")

        # The staged train step's time on one staged batch.
        tds = make_dataset(tcfg.data, tcfg.model, vocab, split="train")
        ttable, tview = stage_on_device(tds, dev)
        if tds.reader.native_reads != DS_VIDEOS:
            raise AssertionError(f"train staging: {tds.reader.native_reads} "
                                 f"native reads of {DS_VIDEOS} videos")
        tbatch = to_device(next(BatchIterator(tview, TRAIN_BATCH,
                                              shuffle=False).epoch(0)), dev)
        step = make_train_step(tcfg, tmodel, make_optimizer(tcfg, 1, tmodel))
        train_step_ms = host_ms(lambda: step(tbatch, ttable), 3)
        train_table_bytes = ttable.numel() * ttable.element_size()
        del ttable, tmodel, step

        # infer.main on one written video with the eval model's weights.
        ckpt = os.path.join(root, "eval_model.pth")
        torch.save({"model": model.state_dict()}, ckpt)
        vid, top = "V0007", 5
        rows = np.load(os.path.join(fields["feature_dir"], f"{vid}.npy"),
                       mmap_mode="r").shape[0]
        queries = ["A person opens the door then sits on the chair.",
                   "Someone takes a cup from the table."]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            infer.main(["--config", base.name, "--torch-checkpoint", ckpt,
                        "--features", os.path.join(fields["feature_dir"],
                                                   f"{vid}.npy"),
                        "--feature-fps", str(DS_FPS), "--top", str(top),
                        "--device", str(dev)]
                       + [a for q in queries for a in ("--query", q)])
        segs = [(float(a), float(b)) for a, b in re.findall(
            r"\[\s*([-\d.]+)s,\s*([-\d.]+)s\]", out.getvalue())]
        dur = rows / DS_FPS
        if len(segs) != top * len(queries) or not all(
                0.0 <= a <= b <= dur + 0.005 for a, b in segs):
            raise AssertionError(f"infer output over [0, {dur}]:\n"
                                 f"{out.getvalue()}")

    n_test = DS_TEST_VIDEOS * DS_QUERIES
    st, sg = runs["streamed"], runs["staged"]
    return dict(
        phase="dataset", config=base.name, dataset="charades",
        corpus=dict(videos=DS_VIDEOS, train_examples=DS_VIDEOS * DS_QUERIES,
                    test_videos=DS_TEST_VIDEOS, test_examples=n_test,
                    feature_bytes=corpus_bytes, write_s=corpus_s,
                    float16_files=len(DS_FLOAT16), glove_rows=vocab.size,
                    unk_tokens=unk),
        native_build_s=native_build_s,
        eval_steps=steps, batch_size=cfg.eval.batch_size,
        launches_per_step={k: n // steps for k, n in st["launches"].items()},
        metrics=st["metrics"], metrics_equal=True,
        streamed_s=st["s"], streamed_qps=n_test / st["s"],
        staged_s=sg["s"], staged_qps=n_test / sg["s"],
        eval_table_bytes=eval_table_bytes,
        reader={k: {f: r[f] for f in ("cache_hits", "cache_misses",
                                      "native_reads")}
                for k, r in runs.items()},
        first_batch_max_err_vs_numpy=read_err,
        train=dict(batch_size=TRAIN_BATCH, steps=2, losses=losses,
                   launches=train_launches, train_s=train_s,
                   step_ms=train_step_ms, table_bytes=train_table_bytes,
                   native_reads=tds.reader.native_reads,
                   embedding_unchanged=True),
        infer=dict(video=vid, duration_s=dur, queries=len(queries), top=top,
                   segments=segs[:top]),
        device=torch.cuda.get_device_name(0))


def serve_phase(base, dev):
    """The HTTP server on the dataset phase's corpus; see the module's
    docstring."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from drn_tpu_torch import serve
    from drn_tpu_torch.evaluate import build_model, predict, to_device
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from drn_tpu_torch.probes import serve_load
    from drn_tpu_torch.utils.profiling import time_fn

    def post(url, payload):
        req = urllib.request.Request(
            url + "/ground", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with tempfile.TemporaryDirectory(prefix="drn_serve_") as root:
        fields = write_corpus(root, base.model.feature_dim)
        fd = fields["feature_dir"]
        cfg = base.replace(data=dataclasses.replace(base.data,
                                                    feature_fps=DS_FPS))
        ckpt = os.path.join(root, "serve_model.pth")
        torch.save({"model": build_model(cfg, device="cpu", seed=2)
                    .state_dict()}, ckpt)
        t0 = time.perf_counter()
        service = serve.build_service(cfg, torch_checkpoint=ckpt,
                                      max_wait_ms=5.0, top=5,
                                      features_root=fd, stage_corpus=True,
                                      device=dev)
        stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        service.start()
        start_s = time.perf_counter() - t0
        httpd = serve.GroundingHTTPServer(("127.0.0.1", 0),
                                          serve.make_handler(service))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        rng = np.random.default_rng(4)
        queries = [" ".join(rng.choice(DS_WORDS, 6)) for _ in range(10)]
        payloads = [{"query": queries[i], "video_id": f"V{i:04d}"}
                    for i in range(SERVE_VIDEO_IDS)]
        payloads += [
            {"query": queries[8], "duration": 12.5,
             "features_path": os.path.join(fd, "V0010.npy")},
            {"query": queries[9], "features": rng.standard_normal(
                (5, base.model.feature_dim), dtype=np.float32).tolist()}]
        try:
            reset_launch_counts()
            batches = service.batches
            answers = [post(url, p) for p in payloads]
            launches = launch_counts()
            batches = service.batches - batches
            want = {k: n * batches for k, n in
                    eval_launches_per_step(cfg.model).items()}
            if batches != len(payloads) or launches != want:
                raise AssertionError(f"serve: {batches} batches for "
                                     f"{len(payloads)} requests, launches "
                                     f"{launches}, expected {want}")
            for p, got in zip(payloads, answers):
                segs, keep, scores = predict(
                    service.cfg, service.model,
                    service.padded_batch([service.prepare(p)]), device=dev)
                kept = [j for j in range(segs.shape[1]) if keep[0, j]][:5]
                ref = {"segments": [[float(segs[0, j, 0]),
                                     float(segs[0, j, 1])] for j in kept],
                       "scores": [float(scores[0, j]) for j in kept]}
                if got != ref or len(kept) != 5:
                    raise AssertionError(f"serve: answer {got} vs predict "
                                         f"{ref} for {list(p)}")
            # One request's batch path without HTTP: the padded batch on
            # the host, its copy to the card, the whole predict (each call
            # synchronised).
            req = service.prepare(payloads[0])
            batch = service.padded_batch([req])
            path_ms = {
                "padded_batch": time_fn(service.padded_batch, [req],
                                        iters=10)["median_ms"],
                "to_device": time_fn(to_device, batch, dev,
                                     iters=10)["median_ms"],
                "predict": time_fn(predict, service.cfg, service.model,
                                   batch, dev, iters=10)["median_ms"]}
            load = []
            for conc in SERVE_CONCURRENCY:
                row = serve_load.run_load(service, url,
                                          payloads[:SERVE_VIDEO_IDS], conc,
                                          SERVE_LOAD_S)
                if row is None or row["errors"]:
                    raise AssertionError(f"serve load at {conc}: {row}")
                load.append(row)
        finally:
            httpd.shutdown()
            service.stop()
    return dict(
        phase="serve", config=base.name, batch_size=service.batch_size,
        staged_videos=len(service._corpus), stage_s=stage_s,
        start_s=start_s, requests=len(payloads),
        kinds=dict(video_id=SERVE_VIDEO_IDS, features_path=1, features=1),
        batches=batches, launches=launches,
        launches_per_batch={k: n // batches for k, n in launches.items()},
        answers_equal_predict=True, first_answer=answers[0],
        batch_path_ms=path_ms, load=load,
        device=torch.cuda.get_device_name(0))


def export_phase(cfg, dev):
    """The exported eval step; see the module's docstring."""
    import torch

    from drn_tpu_torch import export
    from drn_tpu_torch.evaluate import build_model, make_eval_step
    from drn_tpu_torch.probes import export_roundtrip
    from drn_tpu_torch.utils.profiling import host_ms

    per_step = {k: n for k, n in eval_launches_per_step(cfg.model).items()
                if n}
    with tempfile.TemporaryDirectory(prefix="drn_export_") as out:
        ep, sidecar, batch, _ = export_roundtrip.do_export(
            out, cfg.name, None, dev, seeds=(0, 1))
        calls = [n for n in ep.graph.nodes if n.op == "call_function"]
        nodes = dict(Counter(str(n.target).split(".")[1] for n in calls
                             if str(n.target).startswith("drn_tpu_torch.")))
        convs = sorted(n.args[1].meta["val"].shape[0] for n in calls
                       if "conv" in str(n.target)
                       and not str(n.target).startswith("drn_tpu_torch."))
        if nodes != per_step or convs != [1, 1, 2]:
            raise AssertionError(f"export graph: custom ops {nodes} "
                                 f"(expected {per_step}), library convs "
                                 f"of Cout {convs}")
        proc = subprocess.run(
            [sys.executable, "-m", "drn_tpu_torch.probes.export_roundtrip",
             "--mode", "run", "--out", out], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"export run in a fresh process failed "
                                 f"({proc.returncode}):\n{proc.stdout}\n"
                                 f"{proc.stderr[-4000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        if fresh["launches_two_calls"] != {
                k: 2 * per_step.get(k, 0) for k in
                fresh["launches_two_calls"]}:
            raise AssertionError(f"export run launches "
                                 f"{fresh['launches_two_calls']}")

        # The live step and the artifact, in turns, on the host clock.
        call, _ = export.load_exported(os.path.join(out, "drn.pt2"))
        on_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        step = make_eval_step(cfg, build_model(cfg, device=dev, seed=0))
        runs = {"live": lambda: step(on_dev),
                "artifact": lambda: call(None, on_dev)}
        times = {"live": [], "artifact": []}
        for name in ("live", "artifact", "artifact", "live"):
            times[name].append(host_ms(runs[name], 20))
        artifact_bytes = os.path.getsize(os.path.join(out, "drn.pt2"))
    return dict(
        phase="export", config=cfg.name, batch_size=cfg.eval.batch_size,
        custom_op_nodes=nodes, library_conv_couts=convs,
        artifact_bytes=artifact_bytes, export_s=fresh["export_s"],
        fresh_process=fresh, live_step_ms=times["live"],
        artifact_step_ms=times["artifact"],
        device=torch.cuda.get_device_name(0))


# The train CLI in a child, with one config override the CLI has no flag
# for (a step-by-step log); the child's launch counts on its last line.
CK_CHILD = """
import time
t0 = time.perf_counter()
import dataclasses, json, sys
import drn_tpu_torch.train as t
print(json.dumps({"imported_s": time.perf_counter() - t0}), file=sys.stderr,
      flush=True)
from drn_tpu_torch.ops.cuda import launch_counts
real = t.get_config
t.get_config = lambda n: (lambda c: c.replace(train=dataclasses.replace(
    c.train, log_every_steps=1)))(real(n))
try:
    t.main(sys.argv[1:])
finally:
    print(json.dumps({"launches": launch_counts()}), file=sys.stderr,
          flush=True)
"""
PACKAGE_KERNELS = ("fused_stem", "fused_fusion_block", "conv_ln_relu",
                   "fused_fusion")


def _train_child(args, sigterm_after=None, launcher=None):
    """Run the train CLI child to its end → (exit code, {step: loss},
    {step: this process's clock at its line}, the preempted step or None,
    launches, wall s, s to the first step line, stderr). With
    `sigterm_after`, SIGTERM follows that step's line, sent to the
    child's whole process group (its workers too), as a scheduler sends
    it. `launcher` (a command that takes a script, its arguments after
    it) runs CK_CHILD from a file in place of `python -c`."""
    import signal

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    if launcher:
        with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False,
                                         prefix="drn_ck_child_") as f:
            f.write(CK_CHILD)
        cmd = [*launcher, f.name, *args]
        # The script's directory, not the repository, heads its sys.path.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    else:
        cmd = [sys.executable, "-u", "-c", CK_CHILD, *args]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=repo, start_new_session=True, env=env)
    losses, at, preempted, launches, first, lines = {}, {}, None, None, \
        None, []
    imported = in_train = None
    try:
        for line in proc.stderr:
            lines.append(line)
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "launches" in rec:
                launches = rec["launches"]
            elif "imported_s" in rec:
                imported = rec["imported_s"]
            elif "loss" in rec:
                if first is None:
                    first, in_train = time.perf_counter() - t0, rec["t"]
                losses[rec["step"]] = rec["loss"]
                at[rec["step"]] = time.perf_counter()
                if rec["step"] == sigterm_after:
                    os.killpg(proc.pid, signal.SIGTERM)
            elif "preempted" in rec:
                preempted = rec["step"]
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        if launcher:
            os.unlink(f.name)
    return dict(rc=rc, losses=losses, at=at, preempted=preempted,
                launches=launches,
                wall_s=time.perf_counter() - t0, first_step_s=first,
                imported_s=imported, train_to_first_step_s=in_train,
                stderr="".join(lines[-30:]))


def _step_times(r, steps_per_epoch):
    """A child's step ms (median of the gaps between consecutive step
    lines within an epoch, its first logged step left out as warm-up) and
    the ms of each epoch boundary (the gap across it: the last step, the
    in-training eval and the best checkpoint's save)."""
    import statistics

    at = r["at"]
    gaps = {k: (at[k] - at[k - 1]) * 1e3 for k in sorted(at)[1:]
            if k - 1 in at}
    within = [g for k, g in gaps.items() if (k - 1) % steps_per_epoch]
    return statistics.median(within), {
        k - 1: g for k, g in gaps.items() if not (k - 1) % steps_per_epoch}


def _ck_args(base, fields, ckpt_dir, workers):
    """The `checkpoint` phase's train CLI arguments: `base` on the corpus
    `fields`, GloVe mode, B=CK_BATCH, CK_STEPS steps."""
    return ["--config", base.name, "--feature-dir", fields["feature_dir"],
            "--annotation-path", fields["annotation_path"], "--glove-path",
            fields["glove_path"], "--feature-fps", str(DS_FPS),
            "--batch-size", str(CK_BATCH), "--num-workers", str(workers),
            "--max-steps", str(CK_STEPS), "--checkpoint-dir", ckpt_dir]


def checkpoint_phase(dev):
    """Checkpoint directories end to end; see the module's docstring."""
    import numpy as np
    import torch

    from drn_tpu_torch import evaluate as port_eval
    from drn_tpu_torch import export, infer, serve
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import build_vocab, make_dataset

    base = get_config("charades_c3d")
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="drn_ckpt_") as root:
        fields = write_corpus(root, base.model.feature_dim)
        cfg = base.replace(data=dataclasses.replace(
            base.data, **fields, batch_size=CK_BATCH))
        vocab = build_vocab(cfg.data, cfg.model)
        steps_per_epoch = -(-len(make_dataset(
            cfg.data, cfg.model, vocab, split="train")) // CK_BATCH)
        if steps_per_epoch < 8 or CK_STEPS <= steps_per_epoch:
            raise AssertionError(f"{steps_per_epoch} steps an epoch")

        # (a) uninterrupted, fed in process; (b) fed by 2 workers, sent
        # SIGTERM; (c) (b) again: a resume. (a) and (c) cross an epoch
        # boundary, its eval and the best checkpoint's save.
        def args(d, workers):
            return _ck_args(base, fields, os.path.join(root, d), workers)

        runs = {"a": _train_child(args("a", 0)),
                "b": _train_child(args("b", 2),
                                  sigterm_after=CK_SIGTERM_AFTER),
                "c": _train_child(args("b", 2))}
        for name, r in runs.items():
            want_rc = 75 if name == "b" else 0
            if r["rc"] != want_rc or not r["launches"] or not all(
                    r["launches"][k] for k in PACKAGE_KERNELS):
                raise AssertionError(f"child ({name}) exited {r['rc']} "
                                     f"(expected {want_rc}), launches "
                                     f"{r['launches']}:\n{r['stderr']}")
        a_dir = os.path.join(root, "a", base.name, "stage1")
        b_dir = os.path.join(root, "b", base.name, "stage1")
        s = runs["b"]["preempted"]
        if s is None or s < CK_SIGTERM_AFTER or not os.path.exists(
                os.path.join(b_dir, f"{s}.pth")):
            raise AssertionError(f"(b) preempted at {s}; its directory "
                                 f"holds {sorted(os.listdir(b_dir))}")
        resumed = runs["c"]["losses"]
        if sorted(resumed) != list(range(s + 1, CK_STEPS + 1)):
            raise AssertionError(f"(c) logged steps {sorted(resumed)} after "
                                 f"a preemption at {s}")
        loss_rel = {k: abs(v - runs["a"]["losses"][k])
                    / abs(runs["a"]["losses"][k]) for k, v in resumed.items()}
        if max(loss_rel.values()) > TRAIN_LOSS_RTOL:
            raise AssertionError(f"resumed losses vs uninterrupted: "
                                 f"{loss_rel}")
        load = lambda d: torch.load(os.path.join(d, f"{CK_STEPS}.pth"),
                                    weights_only=True)["model"]
        pa, pc = load(a_dir), load(b_dir)
        diff = math.sqrt(sum(float((pc[k] - v).double().pow(2).sum())
                             for k, v in pa.items()))
        norm = math.sqrt(sum(float(v.double().pow(2).sum())
                             for v in pa.values()))
        if diff / norm > RESUME_PARAM_REL:
            raise AssertionError(f"resumed parameters: relative L2 "
                                 f"{diff / norm}")
        feed = {}
        for name, workers in (("a", 0), ("c", 2)):
            ms, boundary = _step_times(runs[name], steps_per_epoch)
            feed[f"workers_{workers}"] = dict(
                child=name, step_ms=ms, examples_per_s=CK_BATCH / ms * 1e3,
                epoch_boundary_ms=boundary)

        # The readers of (a)'s directory against its step files: best/
        # (the eval after step 8) where they prefer it, else the latest.
        best = os.path.join(a_dir, "best", f"{steps_per_epoch}.pth")
        latest = os.path.join(a_dir, f"{CK_STEPS}.pth")
        if not os.path.exists(best):
            raise AssertionError(f"no {best}: {sorted(os.listdir(a_dir))}")
        data_args = ["--annotation-path", fields["annotation_path"],
                     "--glove-path", fields["glove_path"]]
        ev = ["--config", base.name, "--feature-dir", fields["feature_dir"],
              *data_args]
        printed = {}
        for name, extra in (("best", ["--torch-checkpoint", best]),
                            ("dir", ["--checkpoint-dir", a_dir]),
                            ("last", ["--torch-checkpoint", latest]),
                            ("latest", ["--checkpoint-dir", a_dir,
                                        "--latest-checkpoint"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                port_eval.main(ev + extra)
            printed[name] = out.getvalue()
        if printed["best"] != printed["dir"] or \
                printed["last"] != printed["latest"] or \
                len(printed["best"].splitlines()) != 7:
            raise AssertionError(f"evaluate printouts differ: {printed}")

        scfg = cfg.replace(eval=dataclasses.replace(cfg.eval, batch_size=8))
        services = [serve.build_service(scfg, device=dev, top=5,
                                        features_root=fields["feature_dir"],
                                        **src)
                    for src in ({"checkpoint_dir": a_dir},
                                {"torch_checkpoint": best})]
        reqs = [{"query": q, "features_path": os.path.join(
            fields["feature_dir"], f"V{v:04d}.npy")}
                for v, q in ((3, "A person opens the door."),
                             (7, "Someone takes a cup from the table."))]
        answers = [svc._run([svc.prepare(r) for r in reqs])
                   for svc in services]
        if answers[0] != answers[1] or not all(a["segments"]
                                               for a in answers[0]):
            raise AssertionError(f"serve answers differ: {answers}")

        outs = {}
        for name, extra in (("dir", ["--checkpoint-dir", a_dir]),
                            ("pth", ["--torch-checkpoint", latest])):
            path = os.path.join(root, f"{name}.pt2")
            with contextlib.redirect_stdout(io.StringIO()):
                export.main(["--config", base.name, "--batch-size", "8",
                             "--out", path, *data_args, *extra])
            call, _ = export.load_exported(path)
            rng = np.random.default_rng(3)
            spec = export.batch_spec(cfg, 8)
            batch = {
                "features": rng.standard_normal(
                    spec["features"].shape, dtype=np.float32),
                "word_ids": rng.integers(0, vocab.size,
                                         spec["word_ids"].shape).astype(
                                             np.int32),
                "query_mask": np.ones(spec["query_mask"].shape, bool),
                "gt_grid": np.tile(np.float32([[5.0, 20.0]]), (8, 1)),
                "duration": np.full((8,), 30.0, np.float32),
                "valid": np.ones((8,), bool)}
            outs[name] = call(None, batch)
        for k in ("segments_seconds", "nms_keep", "scores", "n_valid"):
            if not torch.equal(outs["dir"][k], outs["pth"][k]):
                raise AssertionError(f"export from the directory: {k} "
                                     "differs")

        inf = {}
        for name, extra in (("dir", ["--checkpoint-dir", a_dir]),
                            ("pth", ["--torch-checkpoint", best])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                infer.main(["--config", base.name, "--features",
                            os.path.join(fields["feature_dir"], "V0007.npy"),
                            "--feature-fps", str(DS_FPS), "--query",
                            "A person opens the door then sits.",
                            *data_args, *extra])
            inf[name] = out.getvalue()
        if inf["dir"] != inf["pth"] or "score=" not in inf["dir"]:
            raise AssertionError(f"infer printouts differ: {inf}")

    return dict(
        phase="checkpoint", config=base.name, dataset="charades",
        glove=True, batch_size=CK_BATCH, steps_per_epoch=steps_per_epoch,
        steps=CK_STEPS, feed=feed,
        children={k: {f: r[f] for f in ("rc", "wall_s", "first_step_s",
                                         "imported_s",
                                         "train_to_first_step_s",
                                         "preempted", "launches")}
                  for k, r in runs.items()},
        preempted_at=s, resume_first_step_s=runs["c"]["first_step_s"],
        losses={k: r["losses"] for k, r in runs.items()},
        resumed_loss_rel=max(loss_rel.values()),
        resumed_param_rel_l2=diff / norm,
        readers_equal=dict(evaluate=True, serve=True, export=True,
                           infer=True),
        phase_s=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0))


@contextlib.contextmanager
def _recorded_steps():
    """{step: (loss, host clock at its record)} of every record the
    trainer logs while the context lasts, at full precision (the
    MetricLogger rounds what it prints; rank 1 prints nothing)."""
    from drn_tpu_torch.utils.logging import MetricLogger

    rec, log = {}, MetricLogger.log

    def recording(self, step, metrics):
        if "loss" in metrics:
            rec[step] = (float(metrics["loss"]), time.perf_counter())
        log(self, step, metrics)

    MetricLogger.log = recording
    try:
        yield rec
    finally:
        MetricLogger.log = log


def _ddp_config(ckpt_dir):
    """The ddp phase's part (b): the flagship model on the synthetic
    fixture at B=DDP_BATCH, logging every step, no periodic eval."""
    from drn_tpu_torch.config import get_config

    base = get_config(CONFIG)
    return base.replace(
        data=dataclasses.replace(base.data, dataset="synthetic",
                                 batch_size=DDP_BATCH,
                                 synthetic_examples=DDP_EXAMPLES),
        train=dataclasses.replace(base.train, checkpoint_dir=ckpt_dir,
                                  log_every_steps=1, eval_every_epochs=0))


def _ddp_rank(rank, world, port, root):
    """One rank of the ddp phase's part (b), spawned: it joins the gloo
    group itself, trains DDP_STEPS steps on the card with the group's
    mesh, evaluates the model over the group, and writes
    `<root>/rank<r>.json`."""
    import datetime

    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from drn_tpu_torch import train as port_train
        from drn_tpu_torch.evaluate import evaluate
        from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
        from drn_tpu_torch.parallel import make_mesh

        mesh = make_mesh()
        cfg = _ddp_config(os.path.join(root, "ranks"))
        with _recorded_steps() as rec:
            reset_launch_counts()
            model = port_train.train(cfg, device="cuda", mesh=mesh,
                                     max_steps=DDP_STEPS)
            launches = launch_counts()
        results = evaluate(cfg, model, device="cuda", mesh=mesh)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, world=mesh.world, launches=launches,
                           losses={k: v[0] for k, v in rec.items()},
                           at={k: v[1] for k, v in rec.items()},
                           results=results), f)
    finally:
        dist.destroy_process_group()


def _median_gap_ms(at):
    """The median ms between consecutive step records (the first step, a
    warm-up, left out)."""
    import statistics

    at = {int(k): v for k, v in at.items()}
    steps = sorted(at)[1:]
    return statistics.median((at[b] - at[a]) * 1e3 for a, b in
                             zip(steps, steps[1:])) if len(steps) > 1 \
        else None


def ddp_phase(ck_line):
    """Data parallel on the one card; see the module's docstring.
    `ck_line` is the `checkpoint` phase's line (its config, its child
    (a)'s losses and step ms)."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from drn_tpu_torch import train as port_train
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, evaluate

    base = get_config(ck_line["config"])
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="drn_ddp_") as root:
        # (a) A group of one over NCCL, through torchrun, against the
        # checkpoint phase's child (a), fed in process like it.
        fields = write_corpus(root, base.model.feature_dim)
        a = _train_child(
            ["--distributed",
             *_ck_args(base, fields, os.path.join(root, "a"), 0)],
            launcher=[sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node=1"])
        if a["rc"] != 0 or not a["launches"] or not all(
                a["launches"][k] for k in PACKAGE_KERNELS):
            raise AssertionError(f"torchrun child exited {a['rc']}, "
                                 f"launches {a['launches']}:\n"
                                 f"{a['stderr']}")
        want = ck_line["losses"]["a"]
        if sorted(a["losses"]) != sorted(want):
            raise AssertionError(f"torchrun child logged steps "
                                 f"{sorted(a['losses'])}, not "
                                 f"{sorted(want)}")
        a_rel = max(abs(v - want[k]) / abs(want[k])
                    for k, v in a["losses"].items())
        if a_rel > TRAIN_LOSS_RTOL:
            raise AssertionError(f"DDP at world size 1: losses "
                                 f"{a['losses']} against {want}")
        a_ms, _ = _step_times(a, ck_line["steps_per_epoch"])

        # (b) Two ranks on the card over gloo, against one process.
        torch.cuda.empty_cache()  # the ranks' memory is their own
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.start_processes(_ddp_rank, args=(DDP_RANKS, port, root),
                                 nprocs=DDP_RANKS, join=False,
                                 start_method="spawn")
        try:
            deadline = time.monotonic() + 600
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError("ddp ranks still running after "
                                         "600 s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(DDP_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for r in ranks:
            if not all(r["launches"].get(k) for k in PACKAGE_KERNELS):
                raise AssertionError(f"rank {r['rank']} launches "
                                     f"{r['launches']}")
        if any(r["losses"] != ranks[0]["losses"] or
               r["results"] != ranks[0]["results"] for r in ranks):
            raise AssertionError(f"the ranks disagree: {ranks}")

        cfg = _ddp_config(os.path.join(root, "one"))
        with _recorded_steps() as rec:
            port_train.train(cfg, device="cuda", max_steps=DDP_STEPS)
        one = {str(k): v[0] for k, v in rec.items()}
        b_loss = ranks[0]["losses"]
        if sorted(b_loss) != sorted(one) or len(one) != DDP_STEPS:
            raise AssertionError(f"steps {sorted(b_loss)} vs {sorted(one)}")
        b_rel = max(abs(v - one[k]) / abs(one[k]) for k, v in b_loss.items())
        if b_rel > TRAIN_LOSS_RTOL:
            raise AssertionError(f"2 ranks' losses {b_loss} against one "
                                 f"process's {one}")
        # One process evaluates what rank 0 saved, with the ranks' data.
        model = build_model(cfg, device="cuda")
        model.load_state_dict(torch.load(
            os.path.join(root, "ranks", cfg.name, "stage1",
                         f"{DDP_STEPS}.pth"), weights_only=True)["model"])
        single = evaluate(cfg, model, device="cuda")
        slack = 100.0 / DDP_EXAMPLES + 1e-6
        eval_diff = max(abs(ranks[0]["results"][k] - v)
                        for k, v in single.items())
        if set(single) != set(ranks[0]["results"]) or eval_diff > slack:
            raise AssertionError(f"2-rank evaluate {ranks[0]['results']} "
                                 f"against one process's {single}")

    return dict(
        phase="ddp",
        torchrun=dict(config=base.name, world=1, backend="nccl",
                      batch_size=CK_BATCH, steps=CK_STEPS,
                      losses=a["losses"], loss_rel_vs_in_process=a_rel,
                      step_ms=a_ms,
                      in_process_step_ms=ck_line["feed"]["workers_0"][
                          "step_ms"],
                      wall_s=a["wall_s"], first_step_s=a["first_step_s"],
                      launches=a["launches"]),
        gloo=dict(config=CONFIG, ranks=DDP_RANKS, backend="gloo",
                  batch_size=DDP_BATCH, rows_a_rank=DDP_BATCH // DDP_RANKS,
                  examples=DDP_EXAMPLES, steps=DDP_STEPS, losses=b_loss,
                  one_process_losses=one, loss_rel_vs_one_process=b_rel,
                  step_ms=_median_gap_ms(ranks[0]["at"]),
                  one_process_step_ms=_median_gap_ms(
                      {k: v[1] for k, v in rec.items()}),
                  launches=[r["launches"] for r in ranks],
                  results=ranks[0]["results"], one_process_results=single,
                  eval_max_diff=eval_diff, eval_slack=slack,
                  ranks_wall_s=ranks_s),
        phase_s=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def _expected_launches(model, steps):
    """The package kernels' launches of `steps` = {"eval": n, "train": m}
    steps of each path."""
    want = Counter()
    for path, per_step in (("eval", eval_launches_per_step),
                           ("train", train_launches_per_step)):
        for k, n in per_step(model).items():
            want[k] += n * steps.get(path, 0)
    return dict(want)


def _bench_child(*flags):
    """`python -m drn_tpu_torch.bench *flags` → (its stdout lines, each a
    JSON object; its stderr records of launches; of measurements; wall
    s). Every launch record must equal the launches a step of each path
    times the steps it reports."""
    from drn_tpu_torch.config import get_config

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "drn_tpu_torch.bench", *flags],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench {' '.join(flags)} exited "
                             f"{proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    out = [json.loads(ln) for ln in proc.stdout.splitlines()]
    recs = [json.loads(ln) for ln in proc.stderr.splitlines()
            if ln.startswith("{")]
    runs = [r for r in recs if "launches" in r]
    meas = [r for r in recs if "measurement" in r]
    _not_clamped(f"bench {' '.join(flags)}", meas)
    for r in runs:
        want = _expected_launches(get_config(r["config"]).model, r["steps"])
        if r["launches"] != want or not r["steps"].get("eval"):
            raise AssertionError(f"bench {r['config']}: launches "
                                 f"{r['launches']}, expected {want} for "
                                 f"{r['steps']} steps")
    return out, runs, meas, wall


def _not_clamped(what, recs):
    """`chained_time` clamps a per-step time that was not positive (the
    host clock's noise over the chain); such a record is no measurement."""
    bad = [r for r in recs if r["clamped"]]
    if bad:
        raise AssertionError(f"{what}: chained_time clamped {bad}")


def _positive(line, keys):
    bad = {k: line.get(k) for k in keys if not (
        isinstance(line.get(k), (int, float)) and math.isfinite(line[k])
        and line[k] > 0)}
    if bad:
        raise AssertionError(f"not positive and finite: {bad} in {line}")


def bench_phase(main_line):
    """The port's benchmark in child processes; see the module's
    docstring. `main_line` is the `main` phase's line."""
    from drn_tpu_torch.bench import ALL_CONFIGS

    phase_t0 = time.perf_counter()
    out, runs, meas, wall = _bench_child("--iters", str(BENCH_ITERS))
    if len(out) != 2 or len(runs) != 1 or any(
            list(ln) != CONTRACT_KEYS for ln in out):
        raise AssertionError(f"bench stdout {out}")
    contract = out[-1]
    if contract["metric"] != \
            "charades_sta_grounding_queries_per_sec_per_chip" or \
            contract["iters"] != BENCH_ITERS:
        raise AssertionError(f"bench contract line {contract}")
    _positive(contract, ("value", "mfu", "train_examples_per_sec",
                         "train_mfu", "vs_baseline"))
    lat, lat_runs, lat_meas, lat_wall = _bench_child(
        "--latency", "--iters", str(LATENCY_ITERS))
    if len(lat) != 1 or lat[0]["metric"] != \
            f"{CONFIG}_single_query_latency_us" or len(lat_runs) != 1:
        raise AssertionError(f"bench --latency stdout {lat}")
    _positive(lat[0], ("value",))
    every, every_runs, every_meas, every_wall = _bench_child(
        "--all-configs", "--skip-train", "--skip-torch", "--iters",
        str(ALL_CONFIGS_ITERS))
    names = [r["config"] for r in every_runs]
    metrics = [ln["metric"] for ln in every]
    if names != list(ALL_CONFIGS) or metrics != [
            "charades_sta_grounding_queries_per_sec_per_chip"] + [
            f"{n}_grounding_queries_per_sec_per_chip" for n in names[1:]]:
        raise AssertionError(f"bench --all-configs: {names}, {metrics}")
    for ln in every:
        _positive(ln, ("value",))
    ev, tr = (next(m for m in meas if m["measurement"] == k)
              for k in ("eval", "train"))
    pick = ("batch_size", "iters", "steps", "step_ms", "k1_ms",
            "flops_per_step", "mfu")
    return dict(
        phase="bench", contract=contract,
        eval={k: ev[k] for k in pick}, train={k: tr[k] for k in pick},
        launches=runs[0]["launches"], steps=runs[0]["steps"],
        latency=dict(line=lat[0], step_ms=lat_meas[0]["step_ms"],
                     steps=lat_runs[0]["steps"]),
        all_configs=[dict(line=ln, batch_size=m["batch_size"],
                          step_ms=m["step_ms"], mfu=m["mfu"],
                          launches=r["launches"])
                     for ln, m, r in zip(every, every_meas, every_runs)],
        main_step_qps=main_line["step_qps"],
        main_step_ms=main_line["step_ms"],
        child_wall_s=dict(bench=wall, latency=lat_wall,
                          all_configs=every_wall),
        phase_s=time.perf_counter() - phase_t0, card=card(),
        device=ev["device"])


def _run_probe(module, argv):
    """`module.main(argv)` in this process → (its stdout's JSON lines, its
    stderr's, the package kernels' launches of the run)."""
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    out, err = io.StringIO(), _Tee(sys.stderr)
    reset_launch_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(argv)
    launches = launch_counts()
    if rc != 0:
        raise AssertionError(f"{module.__name__} returned {rc}")
    as_json = lambda text: [json.loads(ln) for ln in text.splitlines()
                            if ln.startswith("{")]
    return as_json(out.getvalue()), as_json("".join(err.text)), launches


def probes_phase():
    """The host-path and train-step probes; see the module's docstring."""
    import torch

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.probes import (host_pipeline, staged_eval, train_mfu,
                                      train_probe)

    phase_t0 = time.perf_counter()
    model = get_config("charades_c3d").model
    with tempfile.TemporaryDirectory(prefix="drn_probes_") as root:
        out, err, launches = _run_probe(host_pipeline, [
            "--out", os.path.join(root, "host"), *PROBE_CORPUS,
            "--workers", "2", "--iters", str(PROBE_ITERS)])
        *host_rows, host = out
        qps_rec = next(r for r in err if r.get("measurement") == "eval")
        _not_clamped("host_pipeline", [qps_rec])
        if len(host_rows) != 10 or host["device_qps_source"] != "measured" \
                or any(r["examples"] != DS_VIDEOS * DS_QUERIES
                       for r in host_rows) or launches != \
                _expected_launches(model, {"eval": qps_rec["steps"]}):
            raise AssertionError(f"host_pipeline: {out}, launches "
                                 f"{launches}")
        host_s = time.perf_counter() - phase_t0

        t0 = time.perf_counter()
        epochs = 2
        out, err, launches = _run_probe(staged_eval, [
            "--out", os.path.join(root, "staged"), *PROBE_CORPUS,
            "--epochs", str(epochs)])
        staged = out[-1]
        # Two warm-up steps, then (2 streamed + the staged) evaluate calls.
        steps = 2 + (2 + epochs) * -(-DS_VIDEOS * DS_QUERIES // get_config(
            "charades_c3d").eval.batch_size)
        if not staged["metrics_match"] or launches != _expected_launches(
                model, {"eval": steps}):
            raise AssertionError(f"staged_eval: {staged}, launches "
                                 f"{launches}, expected {steps} steps")
        staged_s = time.perf_counter() - t0

    train_rows = {}
    for module, argv in (
            (train_probe, []),
            (train_mfu, ["--probes", "adam,grad_remat,fp32"])):
        t0 = time.perf_counter()
        out, _, launches = _run_probe(module, [
            "--batch-size", str(TRAIN_BATCH), "--iters", str(PROBE_ITERS),
            *argv])
        if not out or not all(launches[k] for k in PACKAGE_KERNELS) or \
                not all(r["ms"] > 0 for r in out):
            raise AssertionError(f"{module.__name__}: {out}, launches "
                                 f"{launches}")
        _not_clamped(module.__name__, out)
        train_rows[module.__name__.rsplit(".", 1)[1]] = dict(
            rows=out, launches=launches, s=time.perf_counter() - t0)
    pick = lambda r, keys: {k: r[k] for k in keys}
    return dict(
        phase="probes",
        host_pipeline=dict(
            rows=[pick(r, ("pipeline", "native_reader", "feature_cache_mb",
                           "epoch", "examples_per_s", "corpus_mb_per_s",
                           "seconds")) for r in host_rows],
            **pick(host, ("corpus_examples", "unique_bytes_per_example_mb",
                          "best_warm", "device_qps", "host_to_device_ratio",
                          "implied_end_to_end_qps", "native_build_s")),
            s=host_s),
        staged_eval=dict(**pick(staged, ("corpus_examples", "table_gb",
                                         "streaming_warm", "staged_best",
                                         "staged_speedup", "metrics_match",
                                         "results")), s=staged_s),
        **train_rows, batch_size=TRAIN_BATCH, iters=PROBE_ITERS,
        phase_s=time.perf_counter() - phase_t0, card=card(),
        device=torch.cuda.get_device_name(0))


def module_probes_phase():
    """The module probes; see the module's docstring."""
    import torch

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.probes import (embed_probe, iou_mix_probe, nms_probe,
                                      pallas_model_check, profile_components,
                                      profile_residual, sample_probe,
                                      stem_probe)

    phase_t0 = time.perf_counter()
    runs = {}

    def run(key, module, *argv):
        t0 = time.perf_counter()
        out, _, launches = _run_probe(module, [
            *argv, "--iters", str(MODULE_ITERS)])
        if not out:
            raise AssertionError(f"{key}: no row")
        _not_clamped(key, out)
        runs[key] = dict(rows=out, launches=launches,
                         s=time.perf_counter() - t0)
        return out

    def fail_on(key, bad):
        if bad:
            raise AssertionError(f"{key}: {bad}")

    nms = run("nms_probe", nms_probe)
    fail_on("nms_probe: keep masks differ", [
        r for r in nms if r["row"] != "package" and not r["same_as_package"]])
    run("profile_components", profile_components)
    run("profile_residual", profile_residual)
    run("profile_residual_tacos", profile_residual, "--config", "tacos_c3d")
    iou = run("iou_mix_probe", iou_mix_probe, "--config", "tacos_c3d")
    fail_on("iou_mix_probe: A against B", [
        r for r in iou if r["row"] == "B"
        and not r["rel_diff"] <= IOU_MIX_REL_TOL])
    for key, argv in (("sample_probe", ()),
                      ("sample_probe_tacos", ("--config", "tacos_c3d"))):
        fail_on(f"{key}: a sampler off the gather", [
            r for r in run(key, sample_probe, *argv)
            if not r["max_err"] <= r["tol"]])
    fail_on("embed_probe: the gradients differ", [
        r for r in run("embed_probe", embed_probe)
        if "max_grad_diff" in r and not r["max_grad_diff"] <= r["grad_tol"]])
    if (stem_probe.ATOL, stem_probe.RTOL) != (KERNEL_ATOL, KERNEL_RTOL) or \
            pallas_model_check.TOL != MAIN_TOL:
        raise AssertionError("a module probe's tolerance is not this "
                             "script's")
    stem = run("stem_probe", stem_probe)
    fail_on("stem_probe: a split off the plain version", [
        r for r in stem if r["row"].startswith("kernel")
        and not r["tol_ratio"] <= 1])
    fail_on("stem_probe: rows", [] if sorted(
        (r["B"], r.get("split")) for r in stem if "split" in r) == [
        (48, 1), (48, 2), (384, 1), (384, 2)] else stem)
    checks = run("pallas_model_check", pallas_model_check)
    want = eval_launches_per_step(get_config(CONFIG).model)
    fail_on("pallas_model_check", [
        r for r in checks if not all(v <= 1 for v in r["tol_ratio"].values())
        or r["launches"] != r["expected_launches"]
        or (r["row"] == "all" and r["launches"] != want)])
    return dict(
        phase="module_probes", iters=MODULE_ITERS, **runs,
        phase_s=time.perf_counter() - phase_t0, card=card(),
        device=torch.cuda.get_device_name(0))


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every kernel's plain version while the block
    runs: each `*_reference` function of the kernels' modules, wherever a
    module of the package holds it (a wrapper's CPU branch, `PLAIN_OPS`),
    is swapped for a counting twin; → the Counter, by name."""
    import functools

    from drn_tpu_torch.models.layers import Ops
    from drn_tpu_torch.ops.cuda import block_probe, conv_block, fused_fusion
    from drn_tpu_torch.ops.cuda import stem

    counts = Counter()

    def counting(name, fn):
        @functools.wraps(fn)
        def twin(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return twin

    twins = {id(fn): counting(name, fn)  # by id: any value can be looked up
             for mod in (conv_block, fused_fusion, stem, block_probe)
             for name, fn in vars(mod).items() if name.endswith("_reference")}
    swapped = []
    for mod in [m for n, m in sys.modules.items()
                if n.startswith("drn_tpu_torch")]:
        for name, v in list(vars(mod).items()):
            if isinstance(v, Ops) and any(id(f) in twins for f in v):
                new = Ops(*(twins.get(id(f), f) for f in v))
            elif id(v) in twins:
                new = twins[id(v)]
            else:
                continue
            swapped.append((mod, name, v))
            setattr(mod, name, new)
    try:
        yield counts
    finally:
        for mod, name, v in swapped:
            setattr(mod, name, v)


def recipe_phase():
    """The recipe probes; see the module's docstring."""
    import torch

    from drn_tpu_torch.probes import (atscale_synthetic, int8_probe,
                                      recipe_demo, recipe_treatment_seeds,
                                      recipe_untrained_rescore_probe,
                                      stage2_regime_ab)

    phase_t0 = time.perf_counter()
    runs, total = {}, Counter()

    def run(key, module, *argv):
        t0 = time.perf_counter()
        out, _, launches = _run_probe(module, list(argv))
        runs[key] = dict(lines=out, launches=launches,
                         s=time.perf_counter() - t0)
        total.update(launches)
        return out

    def fail_on(key, bad):
        if bad:
            raise AssertionError(f"{key}: {bad}")

    cfg = ["--config", RECIPE_CONFIG]
    with tempfile.TemporaryDirectory(prefix="drn_recipe_") as work, \
            plain_calls() as plain:
        demo_run, demo = run("recipe_demo", recipe_demo, *cfg,
                             "--stage1-epochs", "1", "--stage2-epochs", "1",
                             "--seed", "0", "--workdir", work)
        fail_on("recipe_demo", recipe_demo.gate_failures(
            demo_run["results"], demo_run))
        run("recipe_untrained_rescore_probe", recipe_untrained_rescore_probe,
            *cfg, "--seeds", "2", "--workdir",
            os.path.join(work, RECIPE_CONFIG, "stage1"))
        run("recipe_treatment_seeds", recipe_treatment_seeds, *cfg,
            "--seeds", "2", "--stage2-epochs", "1", "--workdir", work)
        run("stage2_regime_ab", stage2_regime_ab, *cfg, "--seeds", "1",
            "--stage2-epochs", "1", "--workdir", work)
        (atscale,) = run("atscale_synthetic", atscale_synthetic)
        int8_rows = run("int8_probe", int8_probe)
    fail_on("int8_probe", int8_probe.gate_failures(int8_rows))
    fail_on("launches", {k: total[k] for k in PACKAGE_KERNELS
                         if not total[k] > 0})
    fail_on("fused_fusion in stage 1's backward", [] if demo_run[
        "launches"]["stage1_train"]["fused_fusion"] > 0 else demo_run)
    fail_on("plain versions called", dict(plain))

    results = demo_run["results"]
    recipe = {k: v["lines"] for k, v in runs.items()
              if k.startswith(("recipe_", "stage2_"))}
    pick = lambda r, keys: {k: r[k] for k in keys if k in r}  # noqa: E731
    return dict(
        phase="recipe", config=RECIPE_CONFIG,
        demo=dict(
            r1_mean={k: recipe_demo.r1_mean(r) for k, r in results.items()},
            r1_iou07={k: r["R@1,IoU=0.7"] for k, r in results.items()},
            plain_minus_stage1=max(abs(results["stage2_plain"][k] - v)
                                   for k, v in results["stage1"].items()),
            moved_outside_iou_head=demo_run["moved_outside_iou_head"],
            stage_s=demo_run["seconds"],
            stage_launches=demo_run["launches"],
            peak_mb=demo_run["peak_mb"]),
        summaries={k: lines[-1] for k, lines in recipe.items()},
        run_lines={k: lines[0] for k, lines in recipe.items()},
        module_s={k: v["s"] for k, v in runs.items()},
        module_launches={k: v["launches"] for k, v in runs.items()},
        atscale=pick(atscale, ("stage1_match", "stage2_rescore", "lift",
                               "moved_outside_iou_head", "seconds",
                               "launches", "peak_mb")),
        int8=[pick(r, ("row", "us", "tflops_equiv", "peak_share",
                       "bound_us", "rel_err", "rel_tol", "speedup_vs_bf16",
                       "acc_equal", "acc_mismatches")) for r in int8_rows],
        launches=dict(total), plain_calls=dict(plain),
        phase_s=time.perf_counter() - phase_t0, card=card(),
        device=torch.cuda.get_device_name(0))


# The recipe phase runs in a child interpreter: in this process, after the
# earlier phases, its launch-bound train steps took 1.8x as long as in a
# fresh one (synthetic_recipe's B=32 step 96 against 54 ms on an H100),
# over ~2,500 steps.
RECIPE_CHILD = ("import json, chip_smoke; "
                "print(json.dumps(chip_smoke.recipe_phase()))")


def recipe_phase_in_child():
    """`recipe_phase` in a new interpreter (its stderr passed through) →
    its line; a child that fails fails the run."""
    proc = subprocess.run(
        [sys.executable, "-c", RECIPE_CHILD], stdout=subprocess.PIPE,
        text=True, timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"the recipe phase exited {proc.returncode} "
                             "(its stderr is above)")
    return json.loads(proc.stdout.splitlines()[-1])


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
    emit(dataset_phase(base, dev))
    emit(serve_phase(base, dev))
    emit(export_phase(base, dev))
    ck_line = checkpoint_phase(dev)
    emit(ck_line)
    emit(ddp_phase(ck_line))
    emit(bench_phase(main_line))
    emit(probes_phase())
    emit(module_probes_phase())
    emit(recipe_phase_in_child())
    # Each kernel's launches on its main path: the eval step's kernels in
    # the `main` run, `fused_fusion` (backward only) in the `train` run,
    # `pallas_block` in the `probe` run.
    launches["fused_fusion"] = train_launches["fused_fusion"]
    launches["pallas_block"] = probe_launches["pallas_block"]

    print(card(), flush=True)

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
