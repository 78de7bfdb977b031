"""The two-stage recipe end to end (port of scripts/recipe_demo.py), and
the helpers the other recipe probes share.

    python -m drn_tpu_torch.probes.recipe_demo [--config synthetic_recipe]
    python -m drn_tpu_torch.probes.recipe_demo --device cpu \\
        --config synthetic_tiny --stage1-epochs 1 --stage2-epochs 1 # a rehearsal

DRN's second-stage IoU head: train the grounding heads (stage 1), then the
IoU head on the model's own regressions (stage 2); rescoring with it
should lift R@n on the held-out val split. The rows, in the JAX script's
order:

    stage1                    stage 1's best, match score only (baseline)
    stage1_rescore_untrained  the same, rescored by its untrained IoU head
    stage2_rescore            stage 2's best, rescored by the trained head
    stage2_plain              stage 2's best, match score only (IoU-only
                              stage 2: equal to stage1, the gain is the
                              rescoring)

The script's choices are kept: the rescore blend pinned to w=1 (the
reference's exact score product), stage-1 selection on the match score
alone, stage 2 from `<workdir>/<cfg.name>/stage1`'s best, and that layout
(`<workdir>/<cfg.name>/stage{1,2}`), so the other recipe probes can reuse
one stage 1. Every evaluation of a run, the trainer's in-training ones
too (`val_eval_fn`), reads one val split drawn once. Output: a `run` JSON line (seconds a stage, the package
kernels' launches a stage, the non-IoU parameters stage 2 moved, peak
device memory, the rows unrounded), the markdown table, then the JAX
script's summary line (`recipe`, `stage1_r1_mean`,
`stage2_rescore_r1_mean`, `improvement`, `results`). Exit 0 when the
trained rescore beats stage 1. Runs on `cuda` unless `--device cpu`; with
no card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from drn_tpu_torch.config import ExperimentConfig, get_config
from drn_tpu_torch.data.pipeline import make_dataset
from drn_tpu_torch.evaluate import (build_model, evaluate, init_parameters,
                                    resolve_device)
from drn_tpu_torch.models import DRN
from drn_tpu_torch.ops.cuda import launch_counts
from drn_tpu_torch.train import selection_metric, train
from drn_tpu_torch.utils.checkpoint import restore_params
from drn_tpu_torch.utils.logging import MetricLogger

ROWS = ("stage1", "stage1_rescore_untrained", "stage2_rescore",
        "stage2_plain")
IOU_HEAD = "iou_head"  # DRN.owner of the IoU head's parameters


def pin_w1(cfg: ExperimentConfig) -> ExperimentConfig:
    """`cfg` with the rescore blend pinned to w=1, as every JAX recipe
    script pins it (their logs predate the w=0.25 default)."""
    return cfg.replace(eval=dataclasses.replace(cfg.eval,
                                                score_iou_weight=1.0))


def eval_with(cfg: ExperimentConfig, model: DRN, rescore: bool,
              split: str = "val", w: Optional[float] = None,
              dataset=None) -> Dict[str, float]:
    """`evaluate` of `model` on `split` (or on `dataset`, a caller's
    `make_dataset` of it, built once for many evaluations) with the IoU
    rescore on or off, at blend `w` (`cfg`'s when None), on the model's
    device."""
    e = dict(score_use_iou_head=rescore)
    if w is not None:
        e["score_iou_weight"] = w
    c = cfg.replace(eval=dataclasses.replace(cfg.eval, **e))
    return evaluate(c, model, dataset, split=split,
                    device=next(model.parameters()).device)


def val_split(cfg: ExperimentConfig):
    """The val split, built once for every evaluation of a run."""
    return make_dataset(cfg.data, cfg.model, split="val")


def val_eval_fn(cfg: ExperimentConfig, val):
    """`train`'s in-training eval (its `eval_fn`) on `val`, the run's val
    split built once: `evaluate` under the stage's `cfg`, logged and
    reduced to the selection metric as `train`'s own eval does (which
    would draw the synthetic split anew for every stage)."""
    log = MetricLogger(f"eval/{cfg.name}")

    def fn(model, epoch):
        results = evaluate(cfg, model, val,
                           device=next(model.parameters()).device)
        log.log(epoch, results)
        return selection_metric(results)

    return fn


def best_params(cfg: ExperimentConfig, ckpt_dir: str
                ) -> Dict[str, torch.Tensor]:
    """Best-on-val params of a finished stage (the latest step when it
    kept no best), after the directory's config check."""
    return restore_params(ckpt_dir, cfg, context="recipe")


def r1_mean(r: Dict[str, float]) -> float:
    vals = [v for k, v in r.items() if k.startswith("R@1")]
    return sum(vals) / len(vals)


def fmt(r: Dict[str, float]) -> str:
    keys = [k for k in r if k.startswith("R@1")] + ["mIoU"]
    return "  ".join(f"{k}={r[k]:.1f}" for k in keys if k in r)


def iou_head_state(model: DRN) -> Dict[str, torch.Tensor]:
    """The IoU head's tensors of `model`'s state_dict."""
    return {k: v for k, v in model.state_dict().items()
            if model.owner(k) == IOU_HEAD}


def fresh_iou_head(model: DRN, seed: int) -> Dict[str, torch.Tensor]:
    """The IoU head a model of `model`'s config starts with at `seed`
    (`evaluate.init_parameters`, one torch.Generator over the whole
    model), as the JAX scripts take `init_params(key(seed))["iou_head"]`:
    seed s's head is the one the trainer's `build_model(seed=s)` draws."""
    fresh = DRN(model.cfg, base_len=model.base_len)
    return iou_head_state(init_parameters(fresh, seed))


def splice_iou_head(state_dict: Dict[str, torch.Tensor],
                    iou_state: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """`state_dict` with its IoU-head tensors replaced by `iou_state`'s,
    every other tensor the same object."""
    unknown = sorted(set(iou_state) - set(state_dict))
    if unknown:
        raise KeyError(f"IoU-head keys outside the state_dict: {unknown}")
    return {**state_dict, **{k: v.to(state_dict[k].device)
                             for k, v in iou_state.items()}}


@torch.no_grad()
def reinit_iou_head(model: DRN, seed: int) -> DRN:
    """`model` with only its IoU head redrawn as at `seed`
    (`fresh_iou_head`); every other tensor is left bit for bit."""
    params = model.state_dict(keep_vars=True)
    for k, v in fresh_iou_head(model, seed).items():
        params[k].copy_(v)
    return model


def moved_outside_iou_head(model: DRN, before: Dict[str, torch.Tensor],
                           after: Dict[str, torch.Tensor]):
    """The non-IoU-head keys whose tensors differ between two state_dicts
    (an IoU-only stage 2 must move none, bit for bit)."""
    return [k for k in before if model.owner(k) != IOU_HEAD
            and not torch.equal(before[k].cpu(), after[k].cpu())]


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The package kernels' launches since `before` (`launch_counts()`)."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def peak_mb(dev: torch.device) -> Optional[float]:
    """Peak device memory allocated since the last reset, MB (None off the
    card)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20


def timed(run: dict, name: str, fn):
    """`fn()`; its seconds go into `run["seconds"][name]` and the package
    kernels' launches into `run["launches"][name]`."""
    t, counts = time.perf_counter(), launch_counts()
    out = fn()
    run.setdefault("seconds", {})[name] = time.perf_counter() - t
    run.setdefault("launches", {})[name] = launch_delta(counts)
    return out


def eval_row(cfg: ExperimentConfig, model: DRN, val, *, rescore: bool,
             w: float = 1.0) -> Dict[str, float]:
    """A row of the resumable probes' state: `eval_with` on `val` at blend
    `w`, each metric rounded to 4 places."""
    return {k: round(v, 4) for k, v in eval_with(
        cfg, model, rescore, w=w, dataset=val).items()}


def load_state(workdir: str, name: str, empty):
    """The JSON state `name` in `workdir`, or `empty` when there is none
    (or it does not parse)."""
    try:
        with open(os.path.join(workdir, name)) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return empty


def save_state(workdir: str, name: str, state) -> None:
    """Write the state atomically (a temporary file renamed into place)."""
    path = os.path.join(workdir, name)
    with open(path + ".tmp", "w") as f:
        json.dump(state, f, indent=1, sort_keys=True)
    os.replace(path + ".tmp", path)


def ensure_stage1(cfg: ExperimentConfig, workdir: str, seed: int, dev, val,
                  log) -> str:
    """Train stage 1 into `workdir` (evaluating on `val`) unless its best
    exists; → its dir."""
    from drn_tpu_torch import train as trainer  # looked up at each call

    stage1_dir = f"{workdir}/{cfg.name}/stage1"
    if os.path.isdir(os.path.join(stage1_dir, "best")):
        log(f"stage 1 checkpoint found in {stage1_dir}; reusing")
    else:
        log(f"stage 1 (seed {seed}) -> {stage1_dir}")
        cfg1 = stage_config(cfg, 1, workdir, seed)
        trainer.train(cfg1, device=dev, eval_fn=val_eval_fn(cfg1, val))
    return stage1_dir


def release(dev) -> None:
    """Free what a finished stage left on the device: its model and
    optimizer are garbage once `train` returned."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def stage_config(cfg: ExperimentConfig, stage: int, workdir: str, seed: int,
                 epochs: Optional[int] = None, **fields) -> ExperimentConfig:
    """`cfg` for one recipe stage into `workdir` (no resume; `fields` set
    more of `cfg.train`'s). Stage 1 selects its best on the match score
    alone: its IoU head is untrained, and rescoring would put that head's
    noise into the selection."""
    t = dataclasses.replace(
        cfg.train, stage=stage, checkpoint_dir=workdir, resume=False,
        seed=seed, **({"num_epochs": epochs} if epochs else {}), **fields)
    c = cfg.replace(train=t)
    if stage == 1:
        c = c.replace(eval=dataclasses.replace(cfg.eval,
                                               score_use_iou_head=False))
    return c


def run_demo(config: str = "synthetic_recipe",
             stage1_epochs: Optional[int] = None,
             stage2_epochs: Optional[int] = None,
             workdir: Optional[str] = None,
             stage2_iou_only: bool = True, seed: int = 0, device=None,
             run: Optional[dict] = None) -> Dict[str, Dict[str, float]]:
    """Stage 1 → eval ×2 → stage 2 → eval (×2 when IoU-only); returns
    {row: metrics} in the JAX rows' order. `run` (a caller's dict)
    receives `seconds` and `launches` a stage (train and eval apart),
    `moved_outside_iou_head` (IoU-only: the non-IoU keys stage 2's best
    differs in from stage 1's, bit for bit) and `peak_mb`."""
    dev = resolve_device(device)
    cfg = pin_w1(get_config(config))
    workdir = workdir or tempfile.mkdtemp(prefix="drn_recipe_")
    run = {} if run is None else run
    run.update(seconds={}, launches={})
    t0 = time.perf_counter()

    def log(msg):
        print(f"[recipe +{time.perf_counter() - t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    val = val_split(cfg)
    cfg1 = stage_config(cfg, 1, workdir, seed, stage1_epochs)
    log(f"stage 1: {cfg1.train.num_epochs} epochs "
        f"({cfg.data.synthetic_examples} train examples, held-out val)")
    timed(run, "stage1_train", lambda: train(
        cfg1, device=dev, eval_fn=val_eval_fn(cfg1, val)))
    stage1_dir = f"{workdir}/{cfg.name}/stage1"
    params1 = best_params(cfg, stage1_dir)
    model = build_model(cfg, device=dev)
    model.load_state_dict(params1)

    results: Dict[str, Dict[str, float]] = {}

    def stage1_evals():
        results["stage1"] = eval_with(cfg, model, False, dataset=val)
        log(f"stage1 (match score only): {fmt(results['stage1'])}")
        results["stage1_rescore_untrained"] = eval_with(cfg, model, True,
                                                        dataset=val)
        log("stage1 + rescore w/ UNTRAINED IoU head: "
            f"{fmt(results['stage1_rescore_untrained'])}")

    timed(run, "stage1_eval", stage1_evals)

    # Stage 2: the IoU head on the model's own regressions, from stage 1's
    # best; its best-on-val IS selected with rescoring.
    cfg2 = stage_config(cfg, 2, workdir, seed, stage2_epochs,
                        stage2_iou_only=stage2_iou_only)
    log(f"stage 2: {cfg2.train.num_epochs} epochs "
        f"(iou_only={stage2_iou_only}) from {stage1_dir}")
    timed(run, "stage2_train", lambda: train(
        cfg2, device=dev, init_from=stage1_dir,
        eval_fn=val_eval_fn(cfg2, val)))
    params2 = best_params(cfg, f"{workdir}/{cfg.name}/stage2")
    model.load_state_dict(params2)

    def stage2_evals():
        results["stage2_rescore"] = eval_with(cfg, model, True, dataset=val)
        log("stage2 + rescore w/ trained IoU head: "
            f"{fmt(results['stage2_rescore'])}")
        if stage2_iou_only:
            results["stage2_plain"] = eval_with(cfg, model, False,
                                                dataset=val)
            log("stage2 WITHOUT rescore (sanity): "
                f"{fmt(results['stage2_plain'])}")

    timed(run, "stage2_eval", stage2_evals)
    if stage2_iou_only:
        run["moved_outside_iou_head"] = moved_outside_iou_head(
            model, params1, params2)
    run["peak_mb"] = peak_mb(dev)
    return results


def gate_failures(results: Dict[str, Dict[str, float]], run: dict):
    """The demo's gates (tests/test_recipe.py's, at 1 epoch a stage on
    synthetic_recipe) and the freeze's bit identity; → the failures. The
    trained rescore beats stage 1 and the untrained rescore by more than
    1.0 R@1-mean, and stage 1 by more than 1.0 at R@1,IoU=0.7; the IoU-only
    stage 2 reproduces stage 1 without rescoring (1e-3 on every metric)
    and moved no parameter outside the IoU head."""
    s1, s2 = r1_mean(results["stage1"]), r1_mean(results["stage2_rescore"])
    s1u = r1_mean(results["stage1_rescore_untrained"])
    bad = []
    if not s2 > s1 + 1.0:
        bad.append(f"stage2_rescore {s2:.2f} <= stage1 {s1:.2f} + 1")
    if not s2 > s1u + 1.0:
        bad.append(f"stage2_rescore {s2:.2f} <= untrained {s1u:.2f} + 1")
    off = {k: (v, results["stage2_plain"][k])
           for k, v in results["stage1"].items()
           if not abs(results["stage2_plain"][k] - v) < 1e-3}
    if off:
        bad.append(f"stage2_plain differs from stage1: {off}")
    r7 = (results["stage2_rescore"]["R@1,IoU=0.7"],
          results["stage1"]["R@1,IoU=0.7"])
    if not r7[0] > r7[1] + 1.0:
        bad.append(f"R@1,IoU=0.7 {r7[0]:.2f} <= stage1 {r7[1]:.2f} + 1")
    if run.get("moved_outside_iou_head"):
        bad.append(f"stage 2 moved {run['moved_outside_iou_head']}")
    return bad


def summary(results: Dict[str, Dict[str, float]]) -> dict:
    """The JAX script's summary line."""
    s1, s2 = r1_mean(results["stage1"]), r1_mean(results["stage2_rescore"])
    return {
        "recipe": "two-stage",
        "stage1_r1_mean": round(s1, 2),
        "stage2_rescore_r1_mean": round(s2, 2),
        "improvement": round(s2 - s1, 2),
        "results": rounded(results),
    }


def print_table(results: Dict[str, Dict[str, float]], first: str) -> None:
    """The JAX scripts' markdown table: a row a result, in order, the
    first row's metrics sorted, under the header `first`."""
    metrics = sorted(results[next(iter(results))])
    header = [first] + metrics
    print("\n| " + " | ".join(header) + " |")
    print("|" + "|".join("---" for _ in header) + "|")
    for row, r in results.items():
        print("| " + " | ".join([row] + [f"{r[m]:.2f}" for m in metrics])
              + " |")
    print()


def rounded(results: Dict[str, Dict[str, float]]):
    return {k: {m: round(v, 2) for m, v in r.items()}
            for k, r in results.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="two-stage recipe demonstration")
    p.add_argument("--config", default="synthetic_recipe")
    p.add_argument("--stage1-epochs", type=int, default=None)
    p.add_argument("--stage2-epochs", type=int, default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--joint", action="store_true",
                   help="stage 2 fine-tunes everything (default: IoU head "
                        "only, which isolates the rescoring effect)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    run: dict = {}
    results = run_demo(
        config=args.config, stage1_epochs=args.stage1_epochs,
        stage2_epochs=args.stage2_epochs, workdir=args.workdir,
        stage2_iou_only=not args.joint, seed=args.seed, device=dev, run=run)
    print(json.dumps({"run": "recipe_demo", "config": args.config, **run,
                      "results": results, "device": str(dev)}), flush=True)
    print_table(results, "recipe step")
    line = summary(results)
    print(json.dumps(line), flush=True)
    return 0 if r1_mean(results["stage2_rescore"]) > r1_mean(
        results["stage1"]) else 1


if __name__ == "__main__":
    sys.exit(main())
