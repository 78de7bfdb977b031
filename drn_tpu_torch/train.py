"""Training (port of drn_tpu/train.py): the two-stage recipe, on one device
or data parallel over a process group.

    python -m drn_tpu_torch.train --config synthetic_tiny --max-steps 3 \\
        --device cpu --checkpoint-dir /tmp/ckpt
    python -m drn_tpu_torch.train --config synthetic_tiny --stage 2 \\
        --init-from /tmp/ckpt/synthetic_tiny/stage1
    torchrun --nproc_per_node=N -m drn_tpu_torch.train --distributed ...

A step is forward → `drn_loss` → backward through the kernels' autograd
Functions (ops/cuda/autograd.py) → the optimizer, which reproduces the JAX
package's optax chain step for step (`Optimizer`). Entry points run on
`cuda` unless the caller passes `device="cpu"`, as evaluate's do. While a
profiler session records, a step is the range `drn.train.step` holding
`drn.train.{gather,forward,loss,backward,optimizer}`, and the loop's batch
fetch is `drn.train.batch` (utils/profiling.py::span).

Real datasets come from `--feature-dir` / `--annotation-path`; with
`--glove-path` the embedding holds the GloVe rows of the dataset's words
and stays frozen; `--device-features` stages every video's grid in one
table on the device, from which each step gathers its batch;
`--num-workers N` builds the batches in N worker processes
(data/pipeline.py::WorkerBatchIterator), the same batches in the same
order.

SIGTERM stops the run at the next step boundary: it force-saves
{model, optimizer, step}, and `main` exits with 75 (utils/preemption.py);
rerun the same command to resume (`train.resume` is the default), mid-epoch
without reading the examples already consumed. `--tensorboard-dir` writes
the logged metrics as TensorBoard scalars too.

Data parallel (`--distributed`, one process per GPU from torchrun's
environment; `train(mesh=...)`; parallel/mesh.py): the model is wrapped
in DistributedDataParallel, each rank trains on its row block of the same
global batch, and the loss is the global batch's (`loss_and_grads`).
Rank 0 alone writes checkpoints, `best/` and the logs; the checkpoint is
the bare model's state_dict, so a directory that N ranks wrote is read
unchanged by one process (resume, evaluate, infer, serve, export) and the
other way round. A preemption stops every rank at the same step, and
every rank exits 75. `--device-features` in a group of more than one
process raises.

Tensor and sequence parallelism (`--model-axis M`, `--time-axis S` under
`--distributed`; `train(mesh=make_mesh(M, S))`): the wide weights are
split over the model ranks (parallel/sharding.py) and the clip axis over
the time ranks (the host moves each time rank's block of the features);
the data axis takes the rest of the ranks. No DDP then: after the
backward each gradient is summed over the data ranks (the loss is the
global batch's, as above), and those of the parameters applied to
time-local activations (backbone, fusion, FPN) over the time ranks too;
a split gradient is this rank's block, a replicated one the same on
every model rank (`reduce_gradients`). The clipping norm adds the split
gradients' squares over the model ranks. Checkpoints hold whole tensors
(the parameters and Adam's moments gathered; each rank takes its block
on restore), so a directory written under one layout reads under any
other, and the model `train` returns is whole on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from drn_tpu_torch.config import ExperimentConfig, get_config, require_drn
from drn_tpu_torch.data.pipeline import (build_vocab, make_batch_iterator,
                                         make_dataset)
from drn_tpu_torch.evaluate import (_refuse_out_of_scope, batch_features,
                                    build_model, eval_batches, evaluate,
                                    resolve_device, stage_on_device,
                                    to_device, with_data_flags)
from drn_tpu_torch.models import DRN
from drn_tpu_torch.models.losses import drn_loss
from drn_tpu_torch.parallel.mesh import (Mesh, all_sum, any_rank, barrier,
                                         check_axes, current_mesh,
                                         init_distributed, make_mesh,
                                         time_slice)
from drn_tpu_torch.parallel.sharding import (TIME_LOCAL_PARTS, gather_params,
                                             shard_model, shard_params,
                                             unshard_model)
from drn_tpu_torch.utils.checkpoint import (BestCheckpointTracker,
                                            CheckpointManager,
                                            check_experiment_config,
                                            config_parity_diffs,
                                            load_experiment_config,
                                            load_model_state,
                                            prefer_best_dir,
                                            save_experiment_config)
from drn_tpu_torch.utils.logging import MetricLogger
from drn_tpu_torch.utils.preemption import PreemptionGuard, exit_code_for
from drn_tpu_torch.utils.profiling import span

# Parameters that are constants of the model, never trained: the LSTMs'
# second bias (flax's cell has one bias per gate; see query_encoder.py).
_CONSTANT_SUFFIX = ".bias_hh_l0"


class Optimizer:
    """The JAX package's `make_optimizer` chain, step for step:

        MultiSteps(every accum_steps,                 # when accum_steps > 1
          multi_transform(train: chain(clip_by_global_norm(grad_clip_norm),
                                       adam(w) with schedule),
                          freeze: set_to_zero))        # stage-2 IoU-only

    over the trained parameters (`params`, parity-schema names); the others
    are not in it and never change. A trained parameter without a gradient
    (the frozen GloVe table) counts as a zero gradient, as a leaf under
    stop_gradient does in the chain: it adds nothing to the norm, its Adam
    moments stay zero and its update is zero. Adam: b1 0.9, b2 0.999, eps
    1e-8, bias correction by the update count; AdamW adds weight_decay · p
    for every parameter but the embedding. The learning rate is optax's
    `piecewise_constant_schedule` read at the count of updates applied
    BEFORE this one, its boundaries `int(epoch · steps_per_epoch /
    accum_steps)` (at least 1), equal boundaries compounded. Clipping:
    g · max_norm / ‖g‖ when ‖g‖ ≥ max_norm, ‖g‖ over the trained
    parameters only. Accumulation: the running mean acc + (g − acc)/(n + 1)
    of `accum_steps` micro-gradients, one update per cycle. Under a model
    axis the parameters in `split` are this rank's blocks: their squares
    are added up over `model_group` for the norm, the others counted
    once."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int,
                 params: Dict[str, nn.Parameter]):
        t = cfg.train
        self.params = params
        self.base_lr = t.learning_rate
        self.max_norm = t.grad_clip_norm
        self.weight_decay = t.weight_decay
        self.accum = max(t.accum_steps, 1)
        updates_per_epoch = steps_per_epoch / self.accum
        self.boundaries: Dict[int, float] = {}
        for e in t.lr_decay_epochs:
            b = max(int(e * updates_per_epoch), 1)
            self.boundaries[b] = self.boundaries.get(b, 1.0) * t.lr_decay_rate
        self.decayed = {n for n in params
                        if t.weight_decay > 0 and not n.startswith("embed.")}
        self.count = 0       # optimizer updates applied
        self.mini_step = 0   # micro-gradients in the current cycle
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.accum > 1 else None
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.split, self.model_group = set(), None

    def learning_rate(self, count: int) -> float:
        """optax.piecewise_constant_schedule at `count`, in fp32 as optax
        computes it."""
        v = torch.tensor(self.base_lr, dtype=torch.float32)
        for threshold, scale in sorted(self.boundaries.items()):
            ind = torch.tensor(float(threshold > count))
            v = v * ind + (1 - ind) * scale * v
        return float(v)

    def step(self) -> bool:
        """Apply the gradients in `.grad` (None counts as zero); True when
        the parameters were updated, False on an accumulation micro-step.
        Multi-tensor (`torch._foreach_*`) arithmetic: a few launches for
        all parameters, no host synchronisation."""
        with span("train.optimizer"):
            return self._step()

    @torch.no_grad()
    def _step(self) -> bool:
        names = list(self.params)
        if not names:
            return True
        ps = [self.params[n] for n in names]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
        if self.acc is not None:
            acc = [self.acc[n] for n in names]
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            if self.mini_step < self.accum - 1:
                self.mini_step += 1
                return False
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            self.mini_step = 0
        norm = self.global_norm(names, grads)
        self.last_grad_norm = norm
        # optax: g unchanged when ‖g‖ < max_norm, else g / ‖g‖ · max_norm.
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        grads = torch._foreach_mul(grads, scale)  # .grad stays as it was
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, grads, alpha=1 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.B2)
        count_inc = self.count + 1
        bc1 = 1.0 - float(torch.tensor(self.B1) ** count_inc)
        bc2 = 1.0 - float(torch.tensor(self.B2) ** count_inc)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        decayed = [i for i, n in enumerate(names) if n in self.decayed]
        if decayed:
            torch._foreach_add_([upd[i] for i in decayed],
                                [ps[i] for i in decayed],
                                alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-self.learning_rate(self.count))
        self.count = count_inc
        return True

    def global_norm(self, names, grads) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if not self.split:
            return torch.linalg.vector_norm(norms)
        split = torch.tensor([n in self.split for n in names],
                             device=norms.device)
        sq = norms * norms
        blocks = all_sum(sq[split].sum(), self.model_group)
        return torch.sqrt(blocks + sq[~split].sum())

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def map_moments(self, state: dict, fn) -> dict:
        """`state` (a `state_dict()`) with `fn` applied to each of its
        moment dicts (mu, nu, acc)."""
        return {**state, **{k: fn(state[k]) for k in ("mu", "nu", "acc")
                            if state[k] is not None}}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc, state["acc"])):
            if mine is not None:
                for n, t in mine.items():
                    t.copy_(theirs[n])


def make_optimizer(cfg: ExperimentConfig, steps_per_epoch: int,
                   model: DRN) -> Optimizer:
    """The optimizer of `cfg` over `model`'s trained parameters. Stage 2
    with `stage2_iou_only` trains the IoU head alone: every other parameter
    gets requires_grad False (so no backward is spent on it) and stays
    bit-identical. The frozen GloVe table is in the optimizer (a zero
    gradient, as in the JAX package's chain) but requires no gradient:
    the model reads it detached, and DistributedDataParallel would wait
    for a gradient that never comes."""
    t = cfg.train
    iou_only = t.stage >= 2 and t.stage2_iou_only
    frozen = {"embed.weight"} if model.query_encoder.freeze_embeddings \
        else set()
    trained = {}
    for name, p in model.state_dict(keep_vars=True).items():
        train_it = not name.endswith(_CONSTANT_SUFFIX) and (
            not iou_only or model.owner(name) == "iou_head")
        p.requires_grad_(train_it and name not in frozen)
        if train_it:
            trained[name] = p
    return Optimizer(cfg, steps_per_epoch, trained)


def loss_and_grads(cfg: ExperimentConfig, model: DRN,
                   batch: Dict[str, torch.Tensor],
                   table: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Forward, `drn_loss`, backward: every trained parameter's `.grad`
    holds its gradient afterwards. A batch without features gathers them
    from the staged `table`. Returns the loss metrics as device tensors.

    `model` may be a DistributedDataParallel of the DRN, each rank holding
    its row block of the global batch: the loss's normalisers are then
    summed over the group, so each rank's loss is its rows' share of the
    global batch's, and the backward runs on world · loss, so that DDP's
    mean of the ranks' gradients is the gradient of the global loss. The
    metrics returned are this rank's shares (`global_metrics` sums
    them)."""
    net, world, global_sum = model, 1, None
    mesh = getattr(model, "mesh", None)
    if isinstance(model, DistributedDataParallel):
        net, group = model.module, model.process_group
        world = dist.get_world_size(group)
        global_sum = lambda t: all_sum(t, group)  # noqa: E731
    elif mesh is not None and mesh.data_group is not None:
        global_sum = lambda t: all_sum(t, mesh.data_group)  # noqa: E731
    for p in net.parameters():
        p.grad = None
    with span("train.gather"):
        features = batch_features(batch, table)
    with span("train.forward"):
        out = model(features, batch["word_ids"], batch["query_mask"])
    with span("train.loss"):
        loss, metrics = drn_loss(cfg.model, cfg.train, out, net.locations,
                                 net.level_ids, batch["gt_grid"],
                                 cfg.data.num_clips, batch["valid"],
                                 global_sum=global_sum)
    with span("train.backward"):
        (loss * world if world > 1 else loss).backward()
        if mesh is not None:
            reduce_gradients(net, mesh)
    return {k: v.detach() for k, v in metrics.items()}


def reduce_gradients(model: DRN, mesh: Mesh) -> None:
    """A split model's gradients after its backward, by class of
    parameter: every one summed over the data ranks (each holds its rows'
    share of the global loss); those applied to time-local activations
    (backbone, fusion, FPN) summed over the time ranks as well, each of
    which saw its block of the clip axis. The rest run whole on every
    time rank (heads, IoU head, query encoder, whose q sums its gradient
    over the time ranks where the fusion reads it), and a split gradient
    is already this rank's block: nothing over the model ranks."""
    named = [(n, p) for n, p in model.state_dict(keep_vars=True).items()
             if p.grad is not None]
    for group, wanted in ((mesh.data_group, lambda n: True),
                          (mesh.time_group,
                           lambda n: model.owner(n) in TIME_LOCAL_PARTS)):
        grads = [p.grad for n, p in named if wanted(n)]
        if group is None or not grads:
            continue
        flat = all_sum(torch.cat([g.reshape(-1) for g in grads]), group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def global_metrics(metrics: Dict[str, torch.Tensor],
                   mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A data-parallel step's metrics for the global batch: the ranks'
    shares summed (one all-reduce), num_pos already global."""
    if mesh is None or mesh.data_group is None:
        return metrics
    keys = [k for k in metrics if k != "num_pos"]
    summed = all_sum(torch.stack([metrics[k] for k in keys]),
                     mesh.data_group)
    return {**metrics, **dict(zip(keys, summed))}


def make_train_step(cfg: ExperimentConfig, model: DRN, optimizer: Optimizer
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(batch of device tensors, staged table or None) → loss metrics
    (device tensors); the model's parameters and the optimizer's state are
    updated in place."""

    def step(batch, table=None):
        with span("train.step"):
            metrics = loss_and_grads(cfg, model, batch, table)
            optimizer.step()
            return metrics

    return step


def selection_metric(results: Optional[Dict[str, float]]) -> Optional[float]:
    """Best-on-val scalar: R@1,IoU=0.5, else the mean of the R@1 rows,
    else of all."""
    if not results:
        return None
    if "R@1,IoU=0.5" in results:
        return float(results["R@1,IoU=0.5"])
    r1 = [v for k, v in results.items() if k.startswith("R@1")]
    return float(np.mean(r1 if r1 else list(results.values())))


def _default_eval_fn(cfg: ExperimentConfig, device, vocab=None,
                     mesh: Optional[Mesh] = None):
    """Periodic eval on the val split (test when there is none), or None
    when neither can be read. A split-less annotation path would score
    the training annotations, so it disables periodic eval. `vocab` is the
    training vocab, so the word ids match the embedding table. Its batch
    iterator lives for the run: with data.num_workers > 0 one pool of
    workers, started by the first eval (not with the run, where its start
    would slow the training pool's), serves every epoch's eval;
    `fn.close()` stops it. Under a `mesh` every rank evaluates its row
    blocks and gets the whole split's metrics (evaluate.eval_counts)."""
    ann = cfg.data.annotation_path
    if ann and "{split}" not in ann:
        print(f"[train] annotation_path {ann!r} has no '{{split}}' "
              "placeholder; skipping in-training eval", flush=True)
        return None
    dataset = None
    for split in [cfg.data.val_split] if cfg.data.val_split else ["val", "test"]:
        try:
            dataset = make_dataset(cfg.data, cfg.model, vocab=vocab,
                                   split=split)
            break
        except FileNotFoundError:
            continue
        except (KeyError, ValueError) as e:
            print(f"[train] WARNING: {split!r} annotations are unreadable "
                  f"({type(e).__name__}: {e}); skipping this split for "
                  "in-training eval", flush=True)
    if dataset is None:
        return None
    log = MetricLogger(f"eval/{cfg.name}")
    batches = eval_batches(cfg, dataset, device, mesh)

    def fn(model, epoch):
        results = evaluate(cfg, model, device=device, batches=batches,
                           mesh=mesh)
        log.log(epoch, results)
        return selection_metric(results)

    fn.close = batches.close
    return fn


def _ddp(model: DRN, dev: torch.device, mesh: Mesh
         ) -> DistributedDataParallel:
    """`model` in DistributedDataParallel over the mesh's group. Made after
    `make_optimizer`: DDP reduces the parameters that then require a
    gradient. Every one of them gets one in every step (the stage-1 IoU
    head a zero gradient, through stage2 · iou_loss), so DDP looks for no
    unused parameter. The buffers are constants of the grid: no sync in
    the forward (the flag's name changed in recent PyTorch)."""
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in
            inspect.signature(DistributedDataParallel).parameters
            else "broadcast_buffers")
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.index is not None else None,
        process_group=mesh.group, find_unused_parameters=False,
        **{sync: False})


def train(cfg: ExperimentConfig, *, device=None,
          init_from: Optional[str] = None, max_steps: Optional[int] = None,
          eval_fn=None, preemption_guard: Optional[PreemptionGuard] = None,
          allow_config_mismatch: bool = False,
          run_info: Optional[dict] = None, mesh: Optional[Mesh] = None,
          device_features: bool = False) -> DRN:
    """A full training run on `device` (cuda by default); returns the
    trained model. `run_info` (a caller's dict) receives `start_step`, the
    step the run began from after any restore, and `step`, where it
    ended. `eval_fn(model, epoch)` → selection metric or None replaces the
    periodic val-split eval. `device_features` stages every training
    video's grid in one table on `device` before the first step
    (data/staging.py).

    SIGTERM stops the loop at the next step boundary: the run logs
    {"preempted": 1.0}, skips the eval and force-saves the step. Pass an
    installed `preemption_guard` to read `guard.triggered` afterwards;
    without one the run installs its own.

    Data parallel under a `mesh` (by default the initialised process
    group's, parallel/mesh.py): every rank calls `train` with the same
    config; the model returned is the bare DRN, the same on every rank.
    Rank 0 writes the directory; every rank returns after the final save
    is on disk."""
    require_drn(cfg, "train")
    mesh = mesh or current_mesh()
    _refuse_out_of_scope(cfg, mesh, device_features)
    split = mesh is not None and mesh.sharded
    if split:
        check_axes(mesh.model_axis, mesh.time_axis, mesh.world, cfg)
    dev = resolve_device(device if device is not None
                         else getattr(mesh, "device", None))
    rank0 = mesh is None or mesh.rank == 0
    tc = cfg.train
    log = MetricLogger(f"train/{cfg.name}/stage{tc.stage}",
                       tensorboard_dir=tc.tensorboard_dir)
    vocab = build_vocab(cfg.data, cfg.model)
    dataset = make_dataset(cfg.data, cfg.model, vocab=vocab, split="train")
    table = None
    if device_features:
        table, dataset = stage_on_device(dataset, dev)
    batches = make_batch_iterator(dataset, cfg.data, shuffle=True,
                                  seed=tc.seed,
                                  pin_memory=dev.type == "cuda",
                                  rank=mesh.data_rank if mesh else 0,
                                  world=mesh.data_world if mesh else 1)
    batches.start()  # worker processes start while the model is built
    guard, own_eval = preemption_guard, None
    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard().install()
    try:
        steps_per_epoch = len(batches)
        model = build_model(cfg, device=dev, seed=tc.seed,
                            pretrained_embeddings=vocab.embeddings)

        ckpt_dir = os.path.join(tc.checkpoint_dir, cfg.name,
                                f"stage{tc.stage}")
        ckpt = CheckpointManager(
            ckpt_dir, keep=tc.keep_checkpoints,
            save_interval_steps=tc.checkpoint_every_steps)
        if init_from:  # stage 2 starts from stage 1's (best-on-val if kept)
            check_experiment_config(init_from, cfg, context="--init-from",
                                    allow_mismatch=allow_config_mismatch)
            model.load_state_dict(
                load_model_state(prefer_best_dir(init_from)))
        specs = shard_model(model, mesh) if split else {}
        rank_block = lambda sd: shard_params(  # noqa: E731
            sd, specs, mesh.model_rank, mesh.model_axis) if split else sd
        whole = lambda sd: gather_params(  # noqa: E731
            sd, specs, mesh.model_group) if split else sd
        optimizer = make_optimizer(cfg, steps_per_epoch, model)
        if split:
            optimizer.split = {n for n in optimizer.params
                               if specs[n] is not None}
            optimizer.model_group = mesh.model_group
        start_step = 0
        if tc.resume:
            check_experiment_config(ckpt_dir, cfg, context="resume",
                                    allow_mismatch=allow_config_mismatch)
            restored = ckpt.restore()
            if restored is not None:
                if "optimizer" not in restored:
                    raise ValueError(
                        f"cannot resume from {ckpt_dir!r}: step "
                        f"{restored['step']} holds the model's parameters "
                        "but no optimizer state (a converted checkpoint?); "
                        "pass it as --init-from, or train into another "
                        "--checkpoint-dir")
                model.load_state_dict(rank_block(restored["model"]))
                optimizer.load_state_dict(optimizer.map_moments(
                    restored["optimizer"], rank_block))
                start_step = int(restored["step"])
        elif rank0:
            stale = load_experiment_config(ckpt_dir)
            if stale is not None and config_parity_diffs(stale, cfg):
                print(f"[train] WARNING: {ckpt_dir!r} holds the provenance "
                      "of a parity-different config "
                      f"({stale.get('name', '?')!r}); overwriting it. Its "
                      "checkpoints belong to the old config.", flush=True)
        barrier("train_restored")  # every rank has read the directory
        if rank0:
            save_experiment_config(ckpt_dir, cfg)
        if run_info is not None:
            run_info["start_step"] = start_step

        if eval_fn is None and tc.eval_every_epochs > 0:
            eval_fn = own_eval = _default_eval_fn(cfg, dev, vocab, mesh)
        best: Optional[BestCheckpointTracker] = None
        net = model if mesh is None or split else _ddp(model, dev, mesh)
        train_step = make_train_step(cfg, net, optimizer)

        def state(step):
            """Whole tensors (a collective under a split mesh)."""
            return {"model": whole(model.state_dict()), "optimizer":
                    optimizer.map_moments(optimizer.state_dict(), whole),
                    "step": step}

        def save_due(step) -> bool:
            """`ckpt.should_save` (rank 0 reads the directory), known to
            every rank when the save is a collective."""
            if not split:
                return rank0 and ckpt.should_save(step)
            return step % ckpt.interval == 0 and any_rank(
                rank0 and ckpt.should_save(step))

        step, done = 0, False
        for epoch in range(tc.num_epochs):
            if done:
                break
            if (epoch + 1) * steps_per_epoch <= start_step:
                step = (epoch + 1) * steps_per_epoch  # covered by the restore
                continue
            skip = max(start_step - step, 0)  # mid-epoch resume point
            step += skip
            model.train()  # cuDNN's LSTM backward runs in training mode only
            loader = iter(batches.epoch(epoch, skip_batches=skip))
            while True:
                with span("train.batch"):
                    batch = next(loader, None)
                if batch is None:
                    break
                metrics = train_step(to_device(time_slice(batch, mesh), dev),
                                     table)
                step += 1
                if step % tc.log_every_steps == 0 or step == 1:
                    log.log(step, {"epoch": epoch,
                                   **global_metrics(metrics, mesh)})
                if save_due(step):
                    full = state(step)
                    if rank0:
                        ckpt.save(step, full)
                if max_steps is not None and step >= max_steps:
                    done = True
                    break
                if guard.preempted_at(step):
                    # Stop now, eval skipped: the grace period is for the
                    # save below.
                    log.log(step, {"epoch": epoch, "preempted": 1.0})
                    done = True
                    break
            if (eval_fn is not None and not done and tc.eval_every_epochs > 0
                    and (epoch + 1) % tc.eval_every_epochs == 0):
                val = eval_fn(model, epoch)
                params = whole(model.state_dict()) if val is not None \
                    else None
                if val is not None and rank0:
                    best = best or BestCheckpointTracker(ckpt_dir)
                    if best.update(step, params, val):
                        log.log(step, {"epoch": epoch,
                                       "best_val_metric": val})
        full = state(step)
        if rank0:
            ckpt.save(step, full, force=True)
        barrier("train_saved")  # the directory is whole for every rank
        unshard_model(model)
    finally:
        batches.close()
        if own_eval is not None:
            own_eval.close()
        log.close()
        if own_guard:
            guard.uninstall()
    if run_info is not None:
        run_info["step"] = step
    return model


def preflight(cfg: ExperimentConfig, sample: int) -> None:
    """The dataset validator on the train split, before any device work:
    its warnings and errors on stderr, SystemExit on an error. A missing
    val split only skips periodic eval, so it does not gate the run."""
    if cfg.data.dataset == "synthetic":
        print("[preflight] synthetic dataset — nothing to validate",
              file=sys.stderr)
        return
    from drn_tpu_torch.data.validate import validate

    report = validate(cfg, splits=("train",), sample=sample)
    for rep in report.get("splits", []):
        for w in rep["warnings"]:
            print(f"[preflight][{rep['split']}] WARN: {w}", file=sys.stderr)
        for e in rep["errors"]:
            print(f"[preflight][{rep['split']}] ERROR: {e}", file=sys.stderr)
    for e in report.get("errors", []):
        print(f"[preflight] ERROR: {e}", file=sys.stderr)
    if not report["ok"]:
        raise SystemExit("preflight validation failed — fix the data errors "
                         "above (or rerun without --preflight)")
    print("[preflight] ok", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description="drn_tpu_torch trainer")
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--stage", type=int, default=None)
    p.add_argument("--stage2-iou-only", action="store_true",
                   help="stage 2: train only the IoU head (the config "
                        "default)")
    p.add_argument("--stage2-joint", action="store_true",
                   help="stage 2: fine-tune the whole network")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--accum-steps", type=int, default=None,
                   help="average this many micro-batch gradients per "
                        "optimizer update (--max-steps, checkpoints and "
                        "logging count micro-steps)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--feature-dir", default=None)
    p.add_argument("--feature-fps", type=float, default=None,
                   help="feature rows per second of video (extraction "
                        "rate); unset configs assume 1.0 with a warning — "
                        "seconds outputs scale by this")
    p.add_argument("--annotation-path", default=None)
    p.add_argument("--glove-path", default=None)
    p.add_argument("--num-workers", type=int, default=None,
                   help="worker processes that build the batches (0: in "
                        "process); the same batches either way")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--init-from", default=None,
                   help="stage-1 checkpoint directory for stage-2 init")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--tensorboard-dir", default=None,
                   help="also write the logged metrics as TensorBoard "
                        "scalars under <dir>/<tag> (needs the tensorboard "
                        "package)")
    p.add_argument("--allow-config-mismatch", action="store_true",
                   help="downgrade the checkpoint-vs-active config check "
                        "(resume / --init-from) to a warning")
    p.add_argument("--preflight", action="store_true",
                   help="run the dataset validator (drn_tpu_torch.data."
                        "validate) on the train split before building the "
                        "model; exit non-zero on anything a run would "
                        "crash on or silently mis-scale")
    p.add_argument("--preflight-sample", type=int, default=200,
                   help="feature files sampled by --preflight")
    p.add_argument("--device-features", action="store_true",
                   help="stage each unique video's resampled features in "
                        "one table on the device before training "
                        "(V*num_clips*F*4 bytes of device memory); epochs "
                        "then read nothing from disk")
    p.add_argument("--model-axis", type=int, default=None,
                   help="tensor-parallel axis size (default: the config's "
                        "MeshConfig.model_axis): ranks that split the wide "
                        "weights' output channels; needs --distributed")
    p.add_argument("--time-axis", type=int, default=None,
                   help="sequence-parallel axis size (default: the "
                        "config's MeshConfig.time_axis): ranks that split "
                        "the clip axis; needs --distributed")
    p.add_argument("--distributed", action="store_true",
                   help="one process per GPU: join the process group from "
                        "torchrun's environment (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT); NCCL on "
                        "cuda, gloo with --device cpu; the data axis "
                        "takes the ranks the model and time axes leave")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    cfg = with_data_flags(get_config(args.config), args)
    require_drn(cfg, "train")
    model_axis = (cfg.mesh.model_axis if args.model_axis is None
                  else args.model_axis)
    time_axis = (cfg.mesh.time_axis if args.time_axis is None
                 else args.time_axis)
    check_axes(model_axis, time_axis, cfg=cfg)
    if (model_axis > 1 or time_axis > 1) and not args.distributed:
        p.error("--model-axis / --time-axis > 1 split the model over the "
                "ranks of a process group: launch with torchrun and "
                "--distributed")
    tr, da = {}, {}
    if args.stage is not None:
        tr["stage"] = args.stage
    if args.stage2_iou_only and args.stage2_joint:
        p.error("--stage2-iou-only and --stage2-joint are mutually exclusive")
    if args.stage2_iou_only:
        tr["stage2_iou_only"] = True
        if tr.get("stage", cfg.train.stage) < 2:
            p.error("--stage2-iou-only requires --stage 2 (the freeze only "
                    "applies to stage-2 training)")
    if args.stage2_joint:
        tr["stage2_iou_only"] = False
    for flag, key in (("accum_steps", "accum_steps"), ("epochs", "num_epochs"),
                      ("lr", "learning_rate"),
                      ("checkpoint_dir", "checkpoint_dir"),
                      ("tensorboard_dir", "tensorboard_dir")):
        if getattr(args, flag) is not None:
            tr[key] = getattr(args, flag)
    if args.batch_size is not None:
        da["batch_size"] = args.batch_size
    if tr:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    if da:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **da))
    if args.preflight:
        preflight(cfg, args.preflight_sample)
    device, mesh, info = args.device, None, {}
    if args.distributed:
        device = init_distributed(args.device)
        mesh = make_mesh(model_axis, time_axis)
    try:
        with PreemptionGuard() as guard:
            train(cfg, device=device, init_from=args.init_from,
                  max_steps=args.max_steps, preemption_guard=guard,
                  allow_config_mismatch=args.allow_config_mismatch,
                  run_info=info, mesh=mesh,
                  device_features=args.device_features)
    finally:
        if args.distributed:
            dist.destroy_process_group()
    if guard.triggered:
        # EX_TEMPFAIL, on every rank: the step is saved; rerunning the
        # command resumes.
        print(f"preempted at step {info['step']}: state saved; rerun to "
              "resume", file=sys.stderr)
        sys.exit(exit_code_for(guard))


if __name__ == "__main__":
    main()
