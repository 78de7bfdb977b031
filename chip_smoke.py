#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (drn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printing one JSON line; the first failure ends the run with a
non-zero exit code. The phases run one after the other in this order,
but for `cli`, which runs after `mesh`:

  1. build    nvcc builds every kernel source of drn_tpu_torch/ops/cuda/csrc
              for sm_90a into the git-ignored build directory.
  2. kernels  each kernel at every distinct shape the flagship eval step
              (charades_c3d_batched_eval, B=48) and train step (B=384:
              forward, the fusion dx convs, the backward kernels, whose
              four outputs are held to their plain versions by relative
              L2 and must see a dropped x̂·mean(gh·x̂) term) give it,
              `fused_fusion` at a model-axis rank's shape (B=384, half
              the columns) and at B=48 (its splits), and the
              stem at activitynet_c3d's Cin=500 (B=16, T=256) and at
              synthetic_recipe's Cin=256 -> Cout=128 (B=64, T=64), and
              2D-TAN's `map_epilogue` at the 8 map-conv shapes of
              tacos_2dtan_c3d's step (B=128, 156x156 to 128x128, C=512,
              bit for bit against its plain version; library: relu(y +
              b) * w in PyTorch's bf16 ops), and `nms_sweep` at 2D-TAN's
              step (B=128, its 2,548 moments) and at DRN's B=2048, K=48
              (bit for bit; the plain version is the PyTorch sweep it
              replaces), held
              against its plain PyTorch version on the card (bf16
              tolerance below), and timed with CUDA events over a CUDA
              graph of back-to-back launches: the kernel, its plain
              version, and `F.conv1d` of the same conv as a yardstick (the
              port never calls it; for a backward kernel with PyTorch's
              LayerNorm forward and backward kernels after it). Every row also carries its grid
              (`blocks`) and achieved `tflops`; conv_ln_relu's and the
              fusion kernels' also the cluster `split` of its columns.
  3. main     `build_model` + `evaluate()` at the flagship width (D=512,
              F=4096, T=64, 3 levels) on the synthetic fixture, 3 batches of
              48 (the last one ragged); the launch counts of that run; the
              same forward with the kernels' plain versions compared; the
              eval step's queries/s, its matmul + conv FLOPs
              (`utils.flops.estimate_flops`, equal through the kernels and
              through the plain versions) and its share of the card's
              bf16 peak (mfu). Then `tan`: 2D-TAN (tacos_2dtan_c3d) through
              `evaluate` on the synthetic fixture, 2 full steps of B=128:
              the launch counts of that run (8 `map_epilogue` and 1
              `nms_sweep` a step, no DRN kernel), the map-conv output
              cells its counter counted (128 x 161,984 a step), the NMS
              candidates (128 x 2,548 a step), finite metrics, queries/s.
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
              other parameter outside the IoU head moved, the backward
              kernels launched), the staged train step's time, and `infer.main` on
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
 11. mesh     tensor and sequence parallelism (the mesh's model and time
              axes; parallel/, the layers' split forms) on the one card,
              ranks spawned with torch.multiprocessing over gloo (NCCL
              refuses two ranks on one device), one spawn for each world
              size, each rank calling, run after run,
              `train(mesh=make_mesh(model, time))` for MESH_STEPS stage-1
              steps on the synthetic fixture, then `evaluate(mesh=...)` of
              the model it returns and one forward of it split again.
              Runs (data, model, time): on 2 ranks (1, 2, 1) at the
              flagship (D=512, F=4096, T=64) at B=384, eval B=48, and (1,
              1, 2) at tacos_c3d (T=512, 4 levels) at B=32, eval B=32; on
              4 ranks (1, 2, 2), (2, 1, 2) and (2, 2, 1) at the flagship
              as before, the second batch of (2, 1, 2) and (2, 2, 1)
              ragged across their data ranks (192 valid rows on data
              rank 0, 24 on 1). Against one
              process's `train()` from the same seed: the losses within
              MESH_LOSS_RTOL; the first step's gradient of every
              parameter (rank 0's, split blocks gathered) and the split
              forward's outputs each held to the plain versions in fp32
              on the same weights and batch, no further from them than
              MESH_FP32_RATIO times the whole path's own distance plus a
              floor; the ranks' evaluate, metric by metric, no further
              from the fp32 plain versions' evaluate of their checkpoint
              (whole tensors) than MESH_FP32_RATIO times one process's
              own distance plus one query. Every rank
              launches the kernels its layout runs (B4 `fused_fusion` in
              place of B2 under the model axis) and calls no plain
              version (`plain_calls`). A CUDA tensor whose shard the
              kernels do not build raises: a conv_ln_relu of Cout 32, and
              a flagship model split over 16 model ranks (at
              `shard_model`, before any step). Step times beside one
              process's: records with the card's name, not claims (gloo
              through the host on one card says nothing of NVLink).
 12. bench    the port's benchmark as users run it, `python -m
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
 13. probes   the probes of the host path and the train step, in this
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
 14. module_probes  the module probes, in this process, chains of
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
 15. recipe   the two-stage recipe probes, in a child interpreter
              (`RECIPE_CHILD`), in one temporary workdir so that one
              stage 1 serves them all:
              `probes.recipe_demo` at synthetic_recipe, 1 epoch a stage,
              seed 0, with tests/test_recipe.py's gates (the trained
              rescore above stage 1 and above the untrained rescore by
              more than 1.0 R@1-mean, above stage 1 by more than 1.0 at
              R@1,IoU=0.7; stage 2 without rescore equal to stage 1 within
              1e-3 on every metric) and stage 2's non-IoU parameters
              bit-identical to stage 1's best; then on its stage 1
              `recipe_untrained_rescore_probe`, `recipe_treatment_seeds`
              and `stage2_regime_ab` (1 seed each, 1 stage-2 epoch), each
              to its summary; `atscale_synthetic` at charades_c3d's width
              (512 / 128 examples, B=64) for ATSCALE_EPOCHS, whose
              freeze and lift checks raise; `int8_probe` at its shape
              (3072, 12288) x (12288, 512): the int32 accumulators equal
              to the same int8 operands multiplied in float64, every row
              within its type's error bound. The four package kernels
              launched over the runs, `fused_fusion_block_bwd` in stage
              1's backward, and no kernel's plain version called
              (`plain_calls`). The line: each gate's numbers, seconds a
              module and a stage, peak device memory.
 16. cli      the repository's recipe scripts as users run them, the two
              side by side (each one's seconds under the other's load),
              with DEVICE unset (the card): `bash
              drn_tpu_torch/scripts/smoke_synthetic.sh` (synthetic_tiny,
              stage 1 for 10 steps, stage 2 for 5, evaluate) and `bash
              drn_tpu_torch/scripts/train_charades_c3d.sh` (charades_c3d's
              full width, F=4096, D=512, B=32, 30 + 30 epochs, GloVe mode)
              on the `dataset` phase's corpus cut to its first CLI_VIDEOS
              videos (written again from its seed; the test split the
              first CLI_TEST_VIDEOS'). A `python` shim first on PATH runs
              each command through CLI_CHILD, which reports the process's
              launches and plain calls. Gates: every process exits 0,
              each script prints 7 metric lines (and the smoke `smoke
              ok`), stage 2 leaves every tensor outside the IoU head
              bit-equal to the stage-1 checkpoint it started from, every
              process launches `fused_stem`, `fused_fusion_block` and
              `conv_ln_relu`, each stage-1 trainer `conv_ln_relu_bwd` and
              `fused_fusion_block_bwd` too (a stage-2 backward stops at
              the IoU head), and none calls a
              plain version. The line: each script's seconds, metrics and
              processes (stage, seconds, launches).

Then the card's name and power limit (nvidia-smi), one JSON line with every
kernel (its entry source and the header its kernel is built on; its
launches from the `main` run, the backward kernels' from the `train` run,
`fused_fusion`'s from rank 0 of the `mesh` phase's (1, 2, 1) run,
`pallas_block`'s from the `probe` run, `map_epilogue`'s and
`nms_sweep`'s from the `tan` run), and last {"ok": true, "device":
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
# Backward kernel vs plain version: each of (dpre, dscale, doffset, db) by
# its relative L2 error, as tests/test_torch_cuda.py's GRAD_REL. Element by
# element would not do: a ReLU mask decided at the fp32 accumulator flips
# where the plain version's fp32 conv, summed in another order, sits on the
# other side of 0. With a cotangent that leans on the output (a regression
# loss's), dpre without its x̂·mean(gh·x̂) term lies 40-100% from the whole
# VJP, 20-50 times this bound; each row checks that it does.
BWD_REL = 2e-2
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
# The mesh phase: per job, its config, train batch and examples a split
# (the flagship's second batch ragged, as ddp's); the (job, (data, model,
# time)) runs, those of one world size in one spawn of ranks.
MESH_STEPS = 3
MESH_JOBS = {"flagship": ("charades_c3d_batched_eval", 384, 600),
             "tacos": ("tacos_c3d", 32, 64)}
MESH_RUNS = (("flagship", (1, 2, 1)), ("tacos", (1, 1, 2)),
             ("flagship", (1, 2, 2)), ("flagship", (2, 1, 2)),
             ("flagship", (2, 2, 1)))
# A split layout's losses against one process's, both through the kernels
# in bf16 from the same weights and batches: on an H100 80GB HBM3 at 700 W
# they differed by 1.0e-4 to 9.2e-4 relative over 3 steps (the split
# LayerNorm's sums in another order); 5e-3 is five times the most.
MESH_LOSS_RTOL = 5e-3
# The split path's first-step gradients and forward outputs are held to
# the plain versions in fp32 on the same weights and batch, no further
# from them than MESH_FP32_RATIO times the whole path's own distance plus
# a floor (MESH_GRAD_FLOOR relative L2 a parameter; MAIN_TOL's atol an
# output). bf16 alone puts the whole path 13.7% from fp32 on the stem's
# weight (cancelling sums over B·T rows of noise features), so the two
# bf16 paths differ by as much between themselves; on an H100 80GB HBM3
# at 700 W the split path's distances were at most 1.06x (gradients) and
# 1.27x (outputs) the whole path's. A gradient summed over an axis too
# many or too few is off by 50-100%. Recall, a count of queries, is held
# the same way, metric by metric, plus one query (`mesh_recall_excess`):
# two bf16 paths part on near ties, and a model-axis split in bf16 moves
# 2 of 600 queries at R@5 on the CPU where in fp32 it moves none
# (tests/test_torch_tensor_parallel.py); a data block counted twice or
# dropped moves 24 or more.
MESH_FP32_RATIO = 1.5
MESH_GRAD_FLOOR = 0.01

CONFIG = "charades_c3d_batched_eval"
EXAMPLES = 120  # 48 + 48 + 24: three eval steps, the last one padded
TRAIN_BATCH = 384  # the config's data.batch_size, its training batch
# 2D-TAN (models/tan.py) at the batch of the benchmark cell that runs it
# (tacos.tan_eval.b128), full steps only: every step computes B × 161,984
# map-conv output cells.
TAN_CONFIG = "tacos_2dtan_c3d"
TAN_BATCH = 128
TAN_STEPS = 2
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
# recipe probes), and atscale's epochs a stage: its defaults are 60 + 40;
# at 30 + 20 its rescore still lifted R@1,IoU=0.5 by 3.125 on an H100
# 80GB HBM3 at 700 W (3.12 at 60 + 40) in half the time.
RECIPE_CONFIG = "synthetic_recipe"
ATSCALE_EPOCHS = (30, 20)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(cfg, dev):
    """Every kernel at every distinct shape of both main paths: error vs
    its plain version, times, bound. Rows of the eval step (B=48), of the
    train step (B=384: the forward's launches, each fusion level's dx
    conv, the backward kernels, the stem's recompute), of a model-axis
    rank's step (`fused_fusion`, half the columns), and the stem at
    activitynet_c3d's Cin=500 and synthetic_recipe's Cout=128 (0 per step:
    coverage). Returns ({(path, kernel): totals per step}, rows)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.models import tan
    from drn_tpu_torch.models.drn import conv_block_sites
    from drn_tpu_torch.ops.cuda import conv_block, fused_fusion, stem
    from drn_tpu_torch.ops.cuda.map_epilogue import (map_epilogue,
                                                     map_epilogue_reference)
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

    def without_variance_term(pre, scale, offset, g, use_act):
        """dpre of the LayerNorm+ReLU VJP at the fp32 rows `pre` with its
        x̂·mean(gh·x̂) term dropped: rstd·(gh − mean(gh))."""
        mean = pre.mean(-1, keepdim=True)
        var = (pre * pre).mean(-1, keepdim=True) - mean * mean
        rstd = torch.rsqrt(var.clamp_min(0.0) + conv_block.LN_EPS)
        gh = g.float() * scale
        if use_act:
            gh = gh * ((pre - mean) * rstd * scale + offset > 0)
        return rstd * (gh - gh.mean(-1, keepdim=True))

    def measure_bwd(path, kernel, shape, count, run, plain, library, pre,
                    use_act, epilogue, g, flops, nbytes):
        """A backward kernel's (dpre, dscale, doffset, db) against its plain
        version's within BWD_REL each, and dpre without the variance's term
        (`pre`: the plain recompute) beyond it; times and bound."""
        with torch.no_grad():
            got, want = run(), plain()
            torch.cuda.synchronize()
            rel = {n: ((a.float() - e.float()).norm()
                       / e.float().norm().clamp_min(1e-30)).item()
                   for n, a, e in zip(("dpre", "dscale", "doffset", "db"),
                                      got, want)}
            dropped = without_variance_term(pre, *epilogue, g, use_act)
            dropped_rel = ((dropped - want[0].float()).norm()
                           / want[0].float().norm()).item()
            if max(rel.values()) > BWD_REL or dropped_rel <= BWD_REL:
                raise AssertionError(
                    f"{kernel} {shape}: relative L2 vs plain {rel}, without "
                    f"the variance's term {dropped_rel:.4g} (bound "
                    f"{BWD_REL})")
            bms, by = bound(flops, nbytes)
            rows.append(dict(
                path=path, kernel=kernel, shape=shape, per_step=count,
                max_abs_err=(got[0].float() - want[0].float()).abs().max()
                .item(), rel_l2=rel, dropped_term_rel_l2=dropped_rel,
                ms=cuda_time_ms(run), plain_ms=cuda_time_ms(plain),
                library_ms=cuda_time_ms(library), bound_ms=bms, bound_by=by,
                flops=flops, bytes=nbytes))

    def library_bwd(conv, epilogue, g, use_act):
        """The yardstick of a backward kernel: cuDNN's conv (`conv`, its
        output (B, Cout, T)) recomputed, PyTorch's LayerNorm forward and
        backward kernels at fp32, the ReLU's mask and the bias's sum."""
        scale, offset = epilogue[1:]

        def run():
            pre = (conv().float().transpose(1, 2) + epilogue[0]).contiguous()
            y, mean, rstd = torch.ops.aten.native_layer_norm(
                pre, (pre.shape[-1],), scale, offset, conv_block.LN_EPS)
            gy = g.float() * (y > 0) if use_act else g.float()
            dpre, ds, do = torch.ops.aten.native_layer_norm_backward(
                gy, pre, (pre.shape[-1],), mean, rstd, scale, offset,
                [True, True, True])
            return dpre.to(torch.bfloat16), ds, do, dpre.sum((0, 1))
        return run

    def bwd_rows(path, b, counts):
        """conv_ln_relu_bwd: one row per distinct shape of a conv block
        with LayerNorm, with its launches per step, its grid (`blocks`,
        one a row tile: split 1) and its achieved TFLOP/s."""
        for (t, cin, k, stride, use_norm, use_act), n in counts.items():
            x = randn(b, t, cin)
            w = randn(k, cin, d, scale=1 / math.sqrt(k * cin))
            epi = epilogue_params(d)
            t_out, left, _ = conv_block.same_padding(t, k, stride)
            g = (conv_block.conv_ln_relu(x, w, *epi, stride, True, use_act)
                 .float() + randn(b, t_out, d, dtype=torch.float32)
                 ).to(torch.bfloat16)
            pre = conv_block.conv_taps(x, w, t_out, left, stride) + epi[0]
            args = (x, w, *epi, g, stride, use_act)
            flops = 2 * b * t_out * k * cin * d
            tiles = -(-b * t_out // conv_block.TILE_ROWS)
            measure_bwd(path, "conv_ln_relu_bwd",
                        dict(B=b, T=t, Cin=cin, Cout=d, K=k, stride=stride,
                             use_act=use_act), n,
                        lambda: conv_block.conv_ln_relu_bwd(*args),
                        lambda: conv_block.conv_ln_relu_bwd_reference(*args),
                        library_bwd(library_conv(x, w, k, stride), epi, g,
                                    use_act),
                        pre, use_act, epi[1:], g, flops,
                        2 * (x.numel() + w.numel() + 2 * g.numel())
                        + 4 * 2 * tiles * 3 * d + 24 * d)
            rows[-1].update(blocks=tiles, split=1,
                            tflops=flops / rows[-1]["ms"] / 1e9)

    def fusion_bwd_rows(path, b, count=1):
        """fused_fusion_block_bwd: one launch per pyramid level."""
        for t in level_ts:
            v, q = randn(b, t, d), randn(b, d, scale=0.5)
            w = randn(kf, d, d, scale=1 / math.sqrt(kf * d))
            epi = epilogue_params(d)
            g = (fused_fusion.fused_fusion_block(v, q, w, *epi).float()
                 + randn(b, t, d, dtype=torch.float32)).to(torch.bfloat16)
            vq = (v * q[:, None, :]).contiguous()
            left = conv_block.same_padding(t, kf, 1)[1]
            pre = conv_block.conv_taps(vq, w, t, left, 1) + epi[0]
            args = (v, q, w, *epi, g)
            flops = 2 * b * t * kf * d * d
            tiles = -(-b * t // conv_block.TILE_ROWS)
            measure_bwd(path, "fused_fusion_block_bwd",
                        dict(B=b, T=t, D=d, K=kf), count,
                        lambda: fused_fusion.fused_fusion_block_bwd(*args),
                        lambda: fused_fusion.fused_fusion_block_bwd_reference(
                            *args),
                        library_bwd(library_conv(vq, w, kf, 1), epi, g, True),
                        pre, True, epi[1:], g, flops,
                        2 * (v.numel() + q.numel() + w.numel()
                             + 2 * g.numel()) + 4 * 2 * tiles * 3 * d
                        + 24 * d)
            rows[-1].update(blocks=tiles, split=1,
                            tflops=flops / rows[-1]["ms"] / 1e9)

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

    def fusion_rows(path, b, epilogue, count=1, dout=d):
        """fused_fusion_block (epilogue) or fused_fusion: one launch per
        pyramid level (`count` a step), with the grid (`blocks`), the
        cluster split of its columns and the achieved TFLOP/s (conv_plan,
        as conv_ln_relu). `dout`: a model-axis rank's share of the
        columns."""
        for t in level_ts:
            v, q = randn(b, t, d), randn(b, d, scale=0.5)
            w = randn(kf, d, dout, scale=1 / math.sqrt(kf * d))
            args = (v, q, w, *epilogue_params(dout)[:3 if epilogue else 1])
            name = "fused_fusion_block" if epilogue else "fused_fusion"
            vq = (v * q[:, None, :]).contiguous()
            flops = 2 * b * t * kf * d * dout
            measure(path, name, dict(B=b, T=t, D=d, Dout=dout, K=kf), count,
                    lambda: getattr(fused_fusion, name)(*args),
                    lambda: getattr(fused_fusion, name + "_reference")(*args),
                    library_conv(vq, w, kf, 1), flops,
                    2 * (v.numel() + q.numel() + w.numel() + b * t * dout)
                    + (12 if epilogue else 4) * dout)
            plan = conv_block.conv_plan(b * t, dout, sms)
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

    def tan_rows(b):
        """map_epilogue: one row per map conv of TAN_CONFIG's step (its
        (H, W) and count weights from `models/tan.py`), one launch each a
        step, held to its plain version bit for bit (the same fp32 sum,
        ReLU and product, one rounding to bf16). Library: the same pass in
        PyTorch's bf16 ops, relu(y + b) · w. Bound: y read and written,
        the bias and w read."""
        tcfg = get_config(TAN_CONFIG)
        m = tcfg.model
        mask = tan.valid_mask(tcfg.data.num_clips // m.frame_pool,
                              m.scale_layers)
        gen = torch.Generator(device=dev).manual_seed(0)
        for layer, w in enumerate(tan.count_weights(
                mask, m.map_kernel_size, m.map_paddings)):
            h, wd, c = *w.shape, m.hidden_dim
            y = torch.randn(b, h, wd, c, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            bias = 0.1 * torch.randn(c, generator=gen, device=dev)
            w = w.to(dev)
            bias16, w16 = bias.bfloat16(), w.bfloat16()[..., None]
            with torch.no_grad():
                want = map_epilogue_reference(y.clone(), bias, w)
                got = map_epilogue(y.clone(), bias, w)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"map_epilogue {(b, h, wd, c)}: max |kernel - plain| "
                        f"{(got.float() - want.float()).abs().max().item()}"
                        f", not bit for bit")
                del got, want
                flops, nbytes = 3 * y.numel(), 4 * y.numel() + 4 * (c + h * wd)
                bms, by = bound(flops, nbytes)
                rows.append(dict(
                    path="tan", kernel="map_epilogue",
                    shape=dict(B=b, H=h, W=wd, C=c, layer=layer), per_step=1,
                    max_abs_err=0.0,
                    ms=cuda_time_ms(
                        lambda: map_epilogue(y, bias, w)),
                    plain_ms=cuda_time_ms(
                        lambda: map_epilogue_reference(y, bias,
                                                                    w)),
                    library_ms=cuda_time_ms(
                        lambda: torch.relu_(y + bias16).mul_(w16)),
                    bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes))
            del y
            torch.cuda.empty_cache()

    def nms_rows():
        """nms_sweep a query a block: at 2D-TAN's step (TAN_BATCH queries,
        its 2,548 moments each in a random rank order) and at DRN's
        B=2048, K=48 (the NMS probe's random segments), each config's
        threshold; bit for bit against its plain version, which is the
        PyTorch sweep the kernel replaces (so library = plain, timed over
        2 calls a graph: ~7,650 launches a call). Bound: ~10 fp32 ops for
        each pair the sweep must test (a survivor and a later candidate)
        and the bytes read and written; the serial chain of survivors,
        which bounds the kernel, is in neither."""
        from drn_tpu_torch.models.tan import moment_cells
        from drn_tpu_torch.ops.cuda.nms_sweep import (nms_sweep,
                                                      nms_sweep_reference,
                                                      sweep_threads)
        from drn_tpu_torch.probes.nms_probe import sweep_inputs

        tcfg = get_config(TAN_CONFIG)
        m = tcfg.model
        cells = torch.tensor(moment_cells(
            tcfg.data.num_clips // m.frame_pool, m.scale_layers))
        moments = torch.stack([cells[:, 0], cells[:, 1] + 1], -1).float() \
            * m.frame_pool
        gen = torch.Generator().manual_seed(0)
        tan_segs = torch.stack([moments[torch.randperm(
            len(moments), generator=gen)] for _ in range(TAN_BATCH)])
        cases = (("tan", tan_segs, tcfg.eval.nms_iou_threshold),
                 ("eval_b2048", torch.from_numpy(sweep_inputs(
                     2048, cfg.eval.top_k, "random")),
                  cfg.eval.nms_iou_threshold))
        for path, segs, thr in cases:
            segs = segs.to(dev).contiguous()
            b, k, _ = segs.shape
            with torch.no_grad():
                want = nms_sweep_reference(segs, thr)
                got = nms_sweep(segs, thr)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"nms_sweep {(b, k)}: {int((got != want).sum())} "
                        "keep bits differ from the plain version")
                ranks = torch.arange(k, device=dev)
                pairs = int(((k - 1 - ranks) * want).sum())
                kept = int(want.sum())
                flops, nbytes = 10 * pairs, 9 * b * k
                bms, by = bound(flops, nbytes)
                plain_ms = cuda_time_ms(
                    lambda: nms_sweep_reference(segs, thr), iters=2, reps=3)
                rows.append(dict(
                    path=path, kernel="nms_sweep",
                    shape=dict(B=b, K=k, threshold=thr,
                               threads=sweep_threads(k),
                               kept_per_query=kept / b),
                    per_step=1, max_abs_err=0.0,
                    ms=cuda_time_ms(lambda: nms_sweep(segs, thr)),
                    plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bms,
                    bound_by=by, flops=flops, bytes=nbytes))
            del want, got
            torch.cuda.empty_cache()

    fwd = [s[1:] for s in conv_block_sites(cfg.model, t0)]
    b = cfg.eval.batch_size
    conv_rows("eval", b, Counter(fwd))
    fusion_rows("eval", b, True)
    stem_row("eval", b, t0, fdim, 1)

    # The train step: the forward's launches, each fusion level's dx conv,
    # the backward kernels (each conv block's and each fusion level's
    # recompute and LayerNorm+ReLU VJP), the stem's recompute.
    dx = [(t, d, kf, 1, False, False) for t in level_ts]
    conv_rows("train", TRAIN_BATCH, Counter(fwd + dx))
    bwd_rows("train", TRAIN_BATCH, Counter(s for s in fwd if s[4]))
    fusion_rows("train", TRAIN_BATCH, True)
    fusion_bwd_rows("train", TRAIN_BATCH)
    stem_row("train", TRAIN_BATCH, t0, fdim, 1)
    stem_row("train", TRAIN_BATCH, t0, fdim, 1, use_norm=False)
    # `fused_fusion` where it runs: a model-axis rank's forward of a
    # fusion level, half the columns (the mesh phase's (1, 2, 1) layout at
    # the train batch), one call a level a step.
    fusion_rows("mesh", TRAIN_BATCH, False, dout=d // 2)

    # fused_fusion at the eval batch's splits, all columns; activitynet_c3d's
    # 500 features: a ragged last k-tile of channels; synthetic_recipe's
    # stem, Cin=256 -> Cout=128, at its eval batch.
    fusion_rows("coverage", b, False, 0)
    stem_row("coverage", 16, 256, 500, 0, config="activitynet_c3d")
    stem_row("coverage", 64, 64, 256, 0, cout=128, config="synthetic_recipe")

    # 2D-TAN's map convs' epilogue, at the 8 shapes of its step.
    tan_rows(TAN_BATCH)
    # The NMS sweep at 2D-TAN's step and at DRN's benchmark eval batch.
    nms_rows()

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
    towers and the IoU head's mixes, and the NMS sweep."""
    return {"fused_stem": 1, "fused_fusion_block": m.num_levels,
            "conv_ln_relu": 3 * m.num_levels + 2 * m.head_tower_layers
            + m.iou_head_layers, "fused_fusion": 0, "pallas_block": 0,
            "conv_ln_relu_bwd": 0, "fused_fusion_block_bwd": 0,
            "map_epilogue": 0, "nms_sweep": 1}


def train_launches_per_step(m):
    """Forward 1 / L / (3L + 2·towers + IoU mixes); the backward recomputes
    the stem with its kernel, takes each conv block's and each fusion
    level's LayerNorm+ReLU VJP in its backward kernel, and runs each
    fusion level's dx conv through `conv_ln_relu`."""
    blocks = 3 * m.num_levels + 2 * m.head_tower_layers + m.iou_head_layers
    return {"fused_stem": 2, "fused_fusion_block": m.num_levels,
            "conv_ln_relu": blocks + m.num_levels, "fused_fusion": 0,
            "pallas_block": 0, "conv_ln_relu_bwd": blocks,
            "fused_fusion_block_bwd": m.num_levels, "map_epilogue": 0,
            "nms_sweep": 0}


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


def tan_phase(dev):
    """2D-TAN (TAN_CONFIG) through `evaluate` on the synthetic fixture,
    TAN_STEPS full steps of TAN_BATCH: the launch counts of that run (one
    `map_epilogue` a map conv a step, one `nms_sweep`, no DRN kernel), the
    map-conv output cells its counter counted (TAN_BATCH × Σ_l H_l·W_l a
    step), the candidates the NMS sweep counted (TAN_BATCH × top_k a
    step), finite metrics, and the run's queries/s."""
    import torch

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import make_dataset
    from drn_tpu_torch.evaluate import build_model, evaluate
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from drn_tpu_torch.ops.cuda.map_epilogue import map_epilogue
    from drn_tpu_torch.ops.cuda.nms_sweep import nms_sweep

    base = get_config(TAN_CONFIG)
    cfg = base.replace(
        data=dataclasses.replace(base.data, dataset="synthetic",
                                 synthetic_examples=TAN_BATCH * TAN_STEPS),
        eval=dataclasses.replace(base.eval, batch_size=TAN_BATCH))
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    dataset = make_dataset(cfg.data, cfg.model, split="test")
    setup_s = time.perf_counter() - t0
    evaluate(cfg, model, dataset, device=dev)  # warm: cuDNN's plans
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = evaluate(cfg, model, dataset, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches, cells = launch_counts(), map_epilogue.cells
    candidates = nms_sweep.candidates
    per_step = {k: 0 for k in launches}
    per_step["map_epilogue"] = cfg.model.map_layers
    per_step["nms_sweep"] = 1
    want = {k: n * TAN_STEPS for k, n in per_step.items()}
    cells_per_step = TAN_BATCH * sum(
        model.map_conv.count_weight(l).numel()
        for l in range(cfg.model.map_layers))
    if launches != want or cells != TAN_STEPS * cells_per_step \
            or candidates != TAN_STEPS * TAN_BATCH * cfg.eval.top_k:
        raise AssertionError(f"2D-TAN launch counts {launches}, expected "
                             f"{want}; map-conv cells {cells}, expected "
                             f"{TAN_STEPS * cells_per_step}; NMS "
                             f"candidates {candidates}")
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"2D-TAN: non-finite or empty metrics: "
                             f"{metrics}")
    del model
    torch.cuda.empty_cache()
    return launches, dict(
        phase="tan", config=TAN_CONFIG, dataset="synthetic",
        examples=len(dataset), steps=TAN_STEPS, batch_size=TAN_BATCH,
        launches=launches, map_conv_cells=cells,
        map_conv_cells_per_step=cells_per_step, nms_candidates=candidates,
        metrics=metrics,
        setup_s=setup_s, evaluate_s=eval_s,
        evaluate_qps=len(dataset) / eval_s,
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


def write_corpus(root, fdim, videos=DS_VIDEOS, test_videos=DS_TEST_VIDEOS):
    """The dataset phase's Charades-STA corpus under `root`, from a seeded
    generator: one `{video}.npy` a video (1 to 200 rows; video 0 exactly
    the 64-row grid, video 1 one row, DS_FLOAT16 in float16), the
    `charades_sta_{train,test}.txt` annotations (start and end in seconds
    inside rows / DS_FPS; the test split the first `test_videos` videos')
    and a 300-d `glove.txt` of every corpus word but DS_NOT_IN_GLOVE, plus
    words the corpus lacks. `videos` cuts the corpus to its first videos,
    drawn as in the whole one. Returns the DataConfig fields that point at
    it."""
    import numpy as np

    rng = np.random.default_rng(9)
    fd = os.path.join(root, "features")
    os.mkdir(fd)
    lines = []
    for v in range(videos):
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
        f.writelines(lines[:test_videos * DS_QUERIES])
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
                   "conv_ln_relu_bwd", "fused_fusion_block_bwd")


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


def _mesh_config(job, ckpt_dir):
    """A mesh job's config: its model on the synthetic fixture at its
    batch, logging every step, no periodic eval."""
    from drn_tpu_torch.config import get_config

    name, batch, examples = MESH_JOBS[job]
    base = get_config(name)
    return base.replace(
        data=dataclasses.replace(base.data, dataset="synthetic",
                                 batch_size=batch,
                                 synthetic_examples=examples),
        train=dataclasses.replace(base.train, checkpoint_dir=ckpt_dir,
                                  log_every_steps=1, eval_every_epochs=0))


@contextlib.contextmanager
def _first_step():
    """The trainer's first step: {"batch": its batch, on the card;
    "params": the state dict it starts from (whole without a model axis);
    "grads": the gradients its optimizer applies, whole (a split
    parameter's blocks gathered over the model ranks), in fp32 on the
    host}."""
    from drn_tpu_torch import train as port_train
    from drn_tpu_torch.parallel.sharding import gather_params

    got = {}
    grads_of, step = port_train.loss_and_grads, port_train.Optimizer.step

    def recording_grads_of(cfg, model, batch, table=None):
        if not got:
            got["batch"] = batch
            got["params"] = {k: v.detach().clone() for k, v in
                             getattr(model, "module", model)
                             .state_dict().items()}
        return grads_of(cfg, model, batch, table)

    def recording_step(self):
        if "grads" not in got:
            grads = {n: p.grad for n, p in self.params.items()
                     if p.grad is not None}
            specs = {n: 0 if n in self.split else None for n in grads}
            got["grads"] = {n: g.float().cpu() for n, g in gather_params(
                grads, specs, self.model_group).items()}
        return step(self)

    port_train.loss_and_grads = recording_grads_of
    port_train.Optimizer.step = recording_step
    try:
        yield got
    finally:
        port_train.loss_and_grads = grads_of
        port_train.Optimizer.step = step


def _fp32(cfg):
    """`cfg` with the model in fp32."""
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 dtype="float32"))


def _fp32_grads(cfg, first):
    """The gradients of the trainer's first step (`_first_step`'s batch
    and weights) through the plain versions in fp32, TF32 off: the
    yardstick both the split and the whole bf16 gradients are held to."""
    from drn_tpu_torch.evaluate import build_model
    from drn_tpu_torch.models.layers import PLAIN_OPS
    from drn_tpu_torch.train import loss_and_grads

    cfg32 = _fp32(cfg)
    plain = build_model(cfg32, device="cuda", ops=PLAIN_OPS).train()
    plain.load_state_dict(first["params"])
    loss_and_grads(cfg32, plain, first["batch"])
    return {k: v.grad.float().cpu() for k, v in
            plain.state_dict(keep_vars=True).items() if v.grad is not None}


def _rel_errors(got, want):
    """{name: ‖got − want‖ / ‖want‖} (‖got‖ where want is 0)."""
    out = {}
    for k, w in want.items():
        wn = w.norm().item()
        out[k] = ((got[k] - w).norm().item() / wn if wn > 0
                  else got[k].norm().item())
    return out


def _mesh_forward(cfg, model, mesh=None):
    """`model`'s outputs on the first eval batch of the fixture's test
    split, in fp32 on the host; under a split `mesh` on a copy split over
    it, from this time rank's block of the features (every rank runs
    it)."""
    import copy

    import torch

    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.evaluate import to_device
    from drn_tpu_torch.parallel import time_slice
    from drn_tpu_torch.parallel.sharding import shard_model

    batch = next(BatchIterator(make_dataset(cfg.data, cfg.model,
                                            split="test"),
                               cfg.eval.batch_size, shuffle=False).epoch(0))
    if mesh is not None:
        model = copy.deepcopy(model)
        shard_model(model, mesh)
    b = to_device(time_slice(batch, mesh), "cuda")
    with torch.no_grad():
        out = model.eval()(b["features"], b["word_ids"], b["query_mask"])
    return {k: out[k].float().cpu() for k in MAIN_TOL}


def _mesh_rank(rank, world, port, root, runs):
    """One rank of the mesh phase, spawned: it joins the gloo group and,
    for each (job, layout) of `runs` in turn, trains MESH_STEPS steps on
    the card under `layout` (data, model, time), keeping the first step's
    gradients, evaluates the model over the mesh and runs one forward of
    it split, counting the kernels' launches (train and evaluate) and any
    plain version's call; → `<root>/<job>_<tag>/rank<r>.json`, and rank
    0's gradients and outputs beside it in `grads.pt`, `outputs.pt`."""
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from drn_tpu_torch import train as port_train
        from drn_tpu_torch.evaluate import evaluate
        from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
        from drn_tpu_torch.parallel import make_mesh

        for job, layout in runs:
            d = os.path.join(root, f"{job}_{_mesh_tag(layout)}")
            mesh = make_mesh(*layout[1:])
            assert mesh.data_world == layout[0], (mesh, layout)
            cfg = _mesh_config(job, os.path.join(d, "ranks"))
            with plain_calls() as plain, _recorded_steps() as rec, \
                    _first_step() as first:
                reset_launch_counts()
                model = port_train.train(cfg, device="cuda", mesh=mesh,
                                         max_steps=MESH_STEPS)
                t0 = time.perf_counter()
                results = evaluate(cfg, model, device="cuda", mesh=mesh)
                eval_s = time.perf_counter() - t0
                launches = launch_counts()
                outputs = _mesh_forward(cfg, model, mesh)
            if rank == 0:
                torch.save(first["grads"], os.path.join(d, "grads.pt"))
                torch.save(outputs, os.path.join(d, "outputs.pt"))
            with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
                json.dump(dict(rank=rank, axes=[mesh.data_rank,
                                                mesh.model_rank,
                                                mesh.time_rank],
                               launches=launches, plain=dict(plain),
                               losses={k: v[0] for k, v in rec.items()},
                               at={k: v[1] for k, v in rec.items()},
                               results=results, eval_s=eval_s), f)
            del model, first
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _mesh_tag(layout):
    return "d{}m{}t{}".format(*layout)


def _spawn_ranks(fn, nprocs, args, timeout_s=600):
    """`fn(rank, nprocs, port, *args)` in `nprocs` spawned processes, on a
    free port; each still alive after `timeout_s` is killed (and fails
    the phase) → seconds."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(fn, args=(nprocs, port, *args), nprocs=nprocs,
                             join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after "
                                     f"{timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return time.perf_counter() - t0


def _coverage_refusals():
    """A shard the kernels do not build raises on the card: the
    conv_ln_relu kernel at Cout 32, and `shard_model` of the flagship
    over 16 model ranks (blocks of 32) before any step → the messages."""
    import torch

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model
    from drn_tpu_torch.ops.cuda.conv_block import conv_ln_relu
    from drn_tpu_torch.parallel.mesh import Mesh
    from drn_tpu_torch.parallel.sharding import shard_model

    said = []
    x = torch.zeros((2, 64, 512), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((3, 512, 32), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros(32, device="cuda")
    m16 = Mesh(rank=0, world=16, local_rank=0, device=None, group=None,
               flags=None, model_axis=16)
    for what in (lambda: conv_ln_relu(x, w, v, v, v),
                 lambda: shard_model(build_model(get_config(CONFIG),
                                                 device="cuda"), m16)):
        try:
            what()
        except ValueError as e:
            said.append(str(e))
        else:
            raise AssertionError("a shard outside the kernels' coverage "
                                 "ran on the card")
    return said


def mesh_phase():
    """Tensor and sequence parallelism on the one card; see the module's
    docstring."""
    import torch

    from drn_tpu_torch import train as port_train
    from drn_tpu_torch.evaluate import build_model, evaluate
    from drn_tpu_torch.models.layers import PLAIN_OPS

    phase_t0 = time.perf_counter()
    refusals = _coverage_refusals()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="drn_mesh_") as root:
        # One process per job, from the same seed: losses, step times,
        # the first step's gradients, and those through the plain
        # versions in fp32 from the same weights and batch.
        one = {}
        for job in MESH_JOBS:
            cfg = _mesh_config(job, os.path.join(root, job, "one"))
            torch.cuda.empty_cache()
            with _recorded_steps() as rec, _first_step() as first:
                port_train.train(cfg, device="cuda", max_steps=MESH_STEPS)
            one[job] = dict(
                losses={str(k): v[0] for k, v in rec.items()},
                ms=_median_gap_ms({k: v[1] for k, v in rec.items()}),
                grads=first["grads"], fp32=_fp32_grads(cfg, first))
            del first
        walls = {}
        for world in sorted({math.prod(layout) for _, layout in MESH_RUNS}):
            group = [(job, layout) for job, layout in MESH_RUNS
                     if math.prod(layout) == world]
            for job, layout in group:
                os.makedirs(os.path.join(root, f"{job}_{_mesh_tag(layout)}"))
            torch.cuda.empty_cache()  # the ranks' memory is their own
            walls[world] = _spawn_ranks(_mesh_rank, world, (root, group))
        for job, layout in MESH_RUNS:
            tag, nprocs = _mesh_tag(layout), math.prod(layout)
            name, batch, examples = MESH_JOBS[job]
            ref = one[job]
            d = os.path.join(root, f"{job}_{tag}")
            cfg = _mesh_config(job, os.path.join(d, "ranks"))
            ranks = []
            for r in range(nprocs):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            # The model axis runs the blocks' split epilogue (LayerNorm
            # outside the kernels), so its backward keeps the recompute.
            runs_on = ("conv_ln_relu", "fused_stem") + (
                ("fused_fusion_block", "fused_fusion_block_bwd",
                 "conv_ln_relu_bwd") if layout[1] == 1 else
                ("fused_fusion",))
            for r in ranks:
                if r["plain"] or not all(r["launches"].get(k)
                                         for k in runs_on):
                    raise AssertionError(
                        f"{job} {tag} rank {r['rank']}: launches "
                        f"{r['launches']}, plain calls {r['plain']}")
            if any(r["losses"] != ranks[0]["losses"] or
                   r["results"] != ranks[0]["results"] for r in ranks):
                raise AssertionError(f"the ranks disagree: {ranks}")
            got = ranks[0]["losses"]
            if sorted(got) != sorted(ref["losses"]) or \
                    len(got) != MESH_STEPS:
                raise AssertionError(f"steps {sorted(got)} vs "
                                     f"{sorted(ref['losses'])}")
            rel = max(abs(v - ref["losses"][k]) / abs(ref["losses"][k])
                      for k, v in got.items())
            if rel > MESH_LOSS_RTOL:
                raise AssertionError(
                    f"{job} {tag}: losses {got} against one process's "
                    f"{ref['losses']}")
            # The first step's gradients, every parameter's, and the
            # whole path's, each against the fp32 plain versions'.
            grads = torch.load(os.path.join(d, "grads.pt"),
                               weights_only=True)
            if sorted(grads) != sorted(ref["grads"]):
                raise AssertionError(f"{job} {tag}: gradients of "
                                     f"{sorted(grads)} vs "
                                     f"{sorted(ref['grads'])}")
            split_err = _rel_errors(grads, ref["fp32"])
            whole_err = _rel_errors(ref["grads"], ref["fp32"])
            excess = {k: split_err[k] - MESH_FP32_RATIO * whole_err[k]
                      for k in split_err}
            worst = max(excess, key=excess.get)
            if excess[worst] > MESH_GRAD_FLOOR:
                raise AssertionError(
                    f"{job} {tag}: gradient of {worst} {split_err[worst]:.4g}"
                    f" from fp32, the whole path's {whole_err[worst]:.4g}")
            far = max(split_err, key=split_err.get)
            vs_one = _rel_errors(grads, ref["grads"])
            # One forward, split on the ranks and whole here, from the
            # ranks' last weights, each against the fp32 plain versions'
            # (a wrong halo row shows at its row).
            model = build_model(cfg, device="cuda")
            model.load_state_dict(torch.load(
                os.path.join(d, "ranks", cfg.name, "stage1",
                             f"{MESH_STEPS}.pth"), weights_only=True)["model"])
            outputs = torch.load(os.path.join(d, "outputs.pt"),
                                 weights_only=True)
            whole_out = _mesh_forward(cfg, model)
            plain32 = build_model(_fp32(cfg), device="cuda", ops=PLAIN_OPS)
            plain32.load_state_dict(model.state_dict())
            fp32_out = _mesh_forward(_fp32(cfg), plain32)
            fp32_results = evaluate(_fp32(cfg), plain32, device="cuda")
            del plain32
            out_err = {}
            for key, (atol, _) in MAIN_TOL.items():
                out_err[key] = {
                    "split": (outputs[key] - fp32_out[key]).abs().max().item(),
                    "whole": (whole_out[key] - fp32_out[key]).abs().max()
                    .item(),
                    "split_vs_whole": (outputs[key] - whole_out[key]).abs()
                    .max().item()}
                e = out_err[key]
                if outputs[key].shape != whole_out[key].shape or \
                        e["split"] > MESH_FP32_RATIO * e["whole"] + atol:
                    raise AssertionError(f"{job} {tag}: {key} from fp32 "
                                         f"{out_err[key]}")
            t0 = time.perf_counter()
            single = evaluate(cfg, model, device="cuda")
            single_s = time.perf_counter() - t0
            if set(single) != set(ranks[0]["results"]) or \
                    set(single) != set(fp32_results):
                raise AssertionError(f"{job} {tag}: metrics "
                                     f"{sorted(ranks[0]['results'])}")
            recall_excess = mesh_recall_excess(
                ranks[0]["results"], single, fp32_results, examples)
            if max(recall_excess.values()) > 1e-6:
                raise AssertionError(
                    f"{job} {tag} evaluate {ranks[0]['results']} against "
                    f"the fp32 plain versions' {fp32_results}, one "
                    f"process's {single}")
            diff = max(abs(ranks[0]["results"][k] - v)
                       for k, v in single.items())
            runs[f"{job}_{tag}"] = dict(
                config=name, layout=list(layout), ranks=nprocs,
                batch_size=batch, eval_batch_size=cfg.eval.batch_size,
                steps=MESH_STEPS, losses=got,
                one_process_losses=ref["losses"],
                loss_rel_vs_one_process=rel,
                grad_rel_err_vs_fp32={
                    "param": far, "split": split_err[far],
                    "whole": whole_err[far],
                    "max_excess": {"param": worst, "value": excess[worst]}},
                max_grad_rel_err_vs_one_process=max(vs_one.values()),
                median_grad_rel_err_vs_one_process=sorted(
                    vs_one.values())[len(vs_one) // 2],
                forward_max_abs_err=out_err,
                step_ms=_median_gap_ms(ranks[0]["at"]),
                one_process_step_ms=ref["ms"],
                eval_s=ranks[0]["eval_s"], one_process_eval_s=single_s,
                results=ranks[0]["results"], one_process_results=single,
                eval_max_diff=diff, fp32_results=fp32_results,
                eval_excess=recall_excess,
                launches=[r["launches"] for r in ranks],
                axes=[r["axes"] for r in ranks], spawn_wall_s=walls[nprocs])
    return dict(phase="mesh", backend="gloo", runs=runs,
                refusals=refusals, card=card(),
                phase_s=time.perf_counter() - phase_t0)


def mesh_recall_excess(split, single, fp32, examples):
    """Each metric's distance of the ranks' evaluate from the fp32 plain
    versions' beyond MESH_FP32_RATIO times one process's own distance
    plus one query → {metric: excess}; one above 0 fails the run."""
    return {k: abs(split[k] - fp32[k])
            - MESH_FP32_RATIO * abs(single[k] - fp32[k]) - 100.0 / examples
            for k in single}


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
            *cfg, "--seeds", "1", "--workdir",
            os.path.join(work, RECIPE_CONFIG, "stage1"))
        run("recipe_treatment_seeds", recipe_treatment_seeds, *cfg,
            "--seeds", "1", "--stage2-epochs", "1", "--workdir", work)
        run("stage2_regime_ab", stage2_regime_ab, *cfg, "--seeds", "1",
            "--stage2-epochs", "1", "--workdir", work)
        (atscale,) = run("atscale_synthetic", atscale_synthetic,
                         "--epochs1", str(ATSCALE_EPOCHS[0]),
                         "--epochs2", str(ATSCALE_EPOCHS[1]))
        int8_rows = run("int8_probe", int8_probe)
    fail_on("int8_probe", int8_probe.gate_failures(int8_rows))
    fail_on("launches", {k: total[k] for k in PACKAGE_KERNELS
                         if not total[k] > 0})
    fail_on("fused_fusion_block_bwd in stage 1's backward", [] if demo_run[
        "launches"]["stage1_train"]["fused_fusion_block_bwd"] > 0
        else demo_run)
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


# The cli phase: the repository's recipe scripts, unmodified. A `python`
# shim first on PATH runs each command the scripts start through CLI_CHILD,
# which runs the module's `main` as `python -m` would, under
# `plain_calls`, and prints the process's launches and plain calls last.
CLI_CHILD = """
import importlib, json, sys, time

if __name__ == "__main__":
    t0 = time.perf_counter()
    if sys.argv[1] != "-m":
        raise SystemExit(f"the shim runs `python -m module`, not {sys.argv}")
    name, argv = sys.argv[2], sys.argv[3:]
    import chip_smoke
    from drn_tpu_torch.ops.cuda import launch_counts

    module = importlib.import_module(name)
    rc, plain = 1, {}
    try:
        with chip_smoke.plain_calls() as plain:
            module.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
        raise
    finally:
        print(json.dumps({"cli_process": name, "argv": argv, "rc": rc,
                          "launches": launch_counts(), "plain": dict(plain),
                          "s": time.perf_counter() - t0}),
              file=sys.stderr, flush=True)
"""
CLI_SCRIPTS = ("smoke_synthetic", "train_charades_c3d")
# The Charades recipe's corpus: the dataset phase's, cut to its first
# CLI_VIDEOS videos (48 train queries: 2 steps an epoch at charades_c3d's
# B=32), the test split the first CLI_TEST_VIDEOS' (24 queries).
CLI_VIDEOS, CLI_TEST_VIDEOS = 16, 8
METRIC_LINE = re.compile(r"^(R@\d,IoU=[\d.]+|mIoU): -?[\d.]+$", re.M)


def _cli_gates(name, out, records, ckpt_root, config):
    """The gates of one script's run → its summary: rc 0 for every
    process, 7 metric lines, stage 2's freeze bit-equal, the package
    kernels launched by every process (the backward kernels by stage 1's
    train) and no plain version called."""
    import torch

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model
    from drn_tpu_torch.utils.checkpoint import (load_model_state,
                                                prefer_best_dir)

    stages = [r["argv"][r["argv"].index("--stage") + 1]
              if "--stage" in r["argv"] else "eval" for r in records]
    if [r["cli_process"] for r in records] != [
            "drn_tpu_torch.train", "drn_tpu_torch.train",
            "drn_tpu_torch.evaluate"] or stages != ["1", "2", "eval"]:
        raise AssertionError(f"{name}: processes {records}")
    for r, stage in zip(records, stages):
        want = ("fused_stem", "fused_fusion_block", "conv_ln_relu") + (
            ("conv_ln_relu_bwd", "fused_fusion_block_bwd")
            if stage == "1" else ())
        if r["rc"] or r["plain"] or not all(r["launches"][k] for k in want):
            raise AssertionError(f"{name} stage {stage}: {r}")
    metrics = dict(m.group(0).split(": ") for m in METRIC_LINE.finditer(out))
    if len(metrics) != 7:
        raise AssertionError(f"{name}: metric lines {metrics}\n{out}")
    stage_dir = os.path.join(ckpt_root, config)
    start = load_model_state(prefer_best_dir(os.path.join(stage_dir,
                                                          "stage1")))
    end = load_model_state(os.path.join(stage_dir, "stage2"))
    model = build_model(get_config(config), device="cpu")
    moved = sorted({model.owner(k) for k in start
                    if not torch.equal(start[k], end[k])})
    if start.keys() != end.keys() or moved != ["iou_head"]:
        raise AssertionError(f"{name}: stage 2 moved {moved}")
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                stage2_moved=moved, processes=[
                    dict(stage=st, s=r["s"], launches=r["launches"])
                    for r, st in zip(records, stages)])


def cli_phase():
    """The recipe scripts as users run them; see the module's
    docstring."""
    import signal

    import torch

    phase_t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="drn_cli_") as root:
        bin_dir = os.path.join(root, "bin")
        os.mkdir(bin_dir)
        child = os.path.join(root, "cli_child.py")
        with open(child, "w") as f:
            f.write(CLI_CHILD)
        shim = os.path.join(bin_dir, "python")
        with open(shim, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" -u "{child}" '
                    '"$@"\n')
        os.chmod(shim, 0o755)
        corpus = os.path.join(root, "corpus")
        os.mkdir(corpus)
        fields = write_corpus(corpus, 4096, videos=CLI_VIDEOS,
                              test_videos=CLI_TEST_VIDEOS)
        env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
        env.update(
            PATH=bin_dir + os.pathsep + env.get("PATH", ""), TMPDIR=root,
            PYTHONPATH=os.pathsep.join(
                p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        ckpt = os.path.join(root, "ckpt")
        extra = {"smoke_synthetic": {}, "train_charades_c3d": dict(
            FEATURES=fields["feature_dir"],
            ANNOTATIONS=fields["annotation_path"],
            GLOVE=fields["glove_path"], CKPT=ckpt)}
        # Both scripts at once: their processes' start-up overlaps.
        procs, logs = {}, {}
        for name in CLI_SCRIPTS:
            logs[name] = (open(os.path.join(root, f"{name}.out"), "w+"),
                          open(os.path.join(root, f"{name}.err"), "w+"))
            procs[name] = (time.perf_counter(), subprocess.Popen(
                ["bash", f"drn_tpu_torch/scripts/{name}.sh"], cwd=repo,
                env={**env, **extra[name]}, stdout=logs[name][0],
                stderr=logs[name][1], start_new_session=True))
        scripts = {}
        try:
            for name, (t0, proc) in procs.items():
                rc = proc.wait(timeout=600)
                scripts[name] = dict(rc=rc, s=time.perf_counter() - t0)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
        for name in CLI_SCRIPTS:
            out, err = (f.seek(0) or f.read() for f in logs[name])
            for f in logs[name]:
                f.close()
            sys.stderr.write(err)
            if scripts[name]["rc"] != 0:
                raise AssertionError(f"{name}.sh exited "
                                     f"{scripts[name]['rc']}")
            records = [json.loads(ln) for ln in err.splitlines()
                       if ln.startswith('{"cli_process"')]
            if name == "smoke_synthetic":
                if out.strip().splitlines()[-1] != "smoke ok":
                    raise AssertionError(f"{name}: {out}")
                (ckpt_root,) = [  # the script's `mktemp -d`
                    os.path.join(root, d) for d in os.listdir(root)
                    if os.path.isdir(os.path.join(root, d, "synthetic_tiny"))]
                config = "synthetic_tiny"
            else:
                ckpt_root, config = ckpt, "charades_c3d"
            scripts[name].update(config=config, **_cli_gates(
                name, out, records, ckpt_root, config))
    return dict(
        phase="cli", scripts=scripts,
        corpus=dict(videos=CLI_VIDEOS, train_examples=CLI_VIDEOS * DS_QUERIES,
                    test_videos=CLI_TEST_VIDEOS,
                    test_examples=CLI_TEST_VIDEOS * DS_QUERIES),
        phase_s=time.perf_counter() - phase_t0, card=card(),
        device=torch.cuda.get_device_name(0))


def main() -> int:
    # The card's host keeps no bytecode of the installed packages: each
    # process compiled torch's modules anew, ~7 s of a 9 s `import torch`
    # on an H100 host. This process and every one it starts share one
    # cache in the checkout.
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_pycache")
    sys.pycache_prefix, sys.dont_write_bytecode = cache, False
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
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
    tan_launches, tan_line = tan_phase(dev)
    emit(tan_line)

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
    mesh_line = mesh_phase()
    emit(mesh_line)
    emit(cli_phase())
    emit(bench_phase(main_line))
    emit(probes_phase())
    emit(module_probes_phase())
    emit(recipe_phase_in_child())
    # Each kernel's launches on its main path: the eval step's kernels in
    # the `main` run, the backward kernels in the `train` run,
    # `fused_fusion` in rank 0 of the model-axis run (1, 2, 1), whose
    # forward alone runs it, `pallas_block` in the `probe` run.
    for name in ("conv_ln_relu_bwd", "fused_fusion_block_bwd"):
        launches[name] = train_launches[name]
    launches["fused_fusion"] = mesh_line["runs"][
        "flagship_" + _mesh_tag((1, 2, 1))]["launches"][0]["fused_fusion"]
    launches["pallas_block"] = probe_launches["pallas_block"]
    launches["map_epilogue"] = tan_launches["map_epilogue"]
    launches["nms_sweep"] = tan_launches["nms_sweep"]

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
        "conv_ln_relu_bwd": ("drn_tpu_torch/ops/cuda/csrc/conv_block.cu",
                             "conv_sm90.cuh",
                             "drn_tpu/ops/pallas/conv_block.py:165"),
        "fused_fusion_block_bwd": (
            "drn_tpu_torch/ops/cuda/csrc/fused_fusion.cu", "conv_sm90.cuh",
            "drn_tpu/ops/pallas/fused_fusion.py:200"),
        "pallas_block": ("drn_tpu_torch/ops/cuda/csrc/block_probe.cu",
                         "conv_sm90.cuh", "scripts/pallas_block_probe.py:52"),
        # 2D-TAN runs in the port alone: no TPU kernel of its own.
        "map_epilogue": ("drn_tpu_torch/ops/cuda/csrc/map_epilogue.cu", None,
                         None),
        # The JAX package's sweep is a lax.fori_loop, no Pallas kernel.
        "nms_sweep": ("drn_tpu_torch/ops/cuda/csrc/nms_sweep.cu", None, None),
    }
    # `pallas_block` at the probe's one shape, its own path.
    totals["probe", "pallas_block"] = Counter(
        max_abs_err=max(probe_line["max_abs_err_vs_plain"].values()),
        **{k: probe_line[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms")},
        **{"bound_" + probe_line["bound_by"]: probe_line["bound_ms"]})
    # Per eval step for the eval path's kernels (their first slice), per
    # train step for the backward kernels, per step of a model-axis rank
    # for `fused_fusion`, per call at the probe's shape for `pallas_block`,
    # per 2D-TAN eval step (B=128) for `map_epilogue` and `nms_sweep`.
    path = {"fused_fusion": "mesh", "pallas_block": "probe",
            "conv_ln_relu_bwd": "train", "fused_fusion_block_bwd": "train",
            "map_epilogue": "tan", "nms_sweep": "tan"}
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
