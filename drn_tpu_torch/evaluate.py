"""Evaluation (port of drn_tpu/evaluate.py): one step = forward → decode →
score → top-k → NMS → recall counts, all on the device; `evaluate()` loops
it over a dataset and fetches the counts once at the end.

`build_model` builds the configuration's architecture: DRN, or 2D-TAN
(models/tan.py) for a configuration whose model is `TANModelConfig`; the
step, the loop and the grading are the same for both (2D-TAN returns its
valid moments' match logits and segments, and scores by the match logit
alone).

Entry points (`build_model`, `evaluate`, `predict`, `main`) run on `cuda`
unless the caller passes `device="cpu"`; with no CUDA device and none
asked for they raise instead of running on the CPU.

`evaluate(..., device_features=True)` stages each unique video's grid in
one table on the evaluation's device (data/staging.py) and the step
gathers its batch from it. `data.num_workers > 0` builds the batches in
worker processes (data/pipeline.py::WorkerBatchIterator); the metrics are
the same.

While a profiler session records, the program opens its own ranges
(utils/profiling.py::span): `drn.eval.pass` around `evaluate`, in it
`drn.eval.batch` (the iterator's next batch), `drn.to_device`,
`drn.eval.step` (holding `drn.eval.gather`, `drn.eval.forward` and
`drn.eval.post`) and `drn.eval.fetch` (the counts' one host wait).

`--checkpoint-dir` reads a directory the port's trainer wrote (its
`best/` first unless `--latest-checkpoint`); an Orbax directory is refused
with the name of its converter, tools/orbax_to_pth.py.

Under a mesh (`evaluate(mesh=...)`, or any evaluation inside an
initialised process group; parallel/mesh.py) each data rank runs its row
block of every batch, and one all-reduce of the counts over the data
ranks after the loop gives every rank the same metrics, each example
counted once. With a model or time axis, `evaluate` splits a whole model
itself (a copy, parallel/sharding.py::shard_model), and each time rank
moves its block of the features to the device. Staging
(`device_features`) in a group of more than one process is refused.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from drn_tpu_torch.config import ExperimentConfig, architecture, get_config
from drn_tpu_torch.convert import load_torch_checkpoint
from drn_tpu_torch.data.pipeline import (build_vocab, make_batch_iterator,
                                         make_dataset)
from drn_tpu_torch.models import DRN
from drn_tpu_torch.models.layers import KERNEL_OPS, Ops
from drn_tpu_torch.models.tan import TAN
from drn_tpu_torch.ops.metrics import metric_name, recall_at_n
from drn_tpu_torch.ops.nms import batched_temporal_nms
from drn_tpu_torch.parallel.mesh import (Mesh, all_sum, check_axes,
                                         current_mesh, time_slice)
from drn_tpu_torch.parallel.sharding import shard_model
from drn_tpu_torch.utils.checkpoint import restore_params
from drn_tpu_torch.utils.profiling import span


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when None; raises when CUDA is asked for
    (explicitly or by default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return dev


def init_parameters(model: DRN, seed: int = 0) -> DRN:
    """Seeded random weights, scaled as the JAX package initialises them:
    LayerNorm scales and the per-level distance scales 1, biases 0,
    embedding N(0, 0.1²), every other weight N(0, 1/fan_in)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.state_dict(keep_vars=True).items():
            if name == "scales" or ("norm" in name and name.endswith("weight")):
                p.fill_(1.0)  # every LayerNorm's name holds "norm"
            elif "bias" in name:
                p.zero_()
            elif name == "embed.weight" or name.endswith(".embed.weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            else:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
    return model


def build_model(cfg: ExperimentConfig, device=None, seed: int = 0,
                ops: Ops = KERNEL_OPS,
                pretrained_embeddings: Optional[np.ndarray] = None) -> DRN:
    """The model of `cfg` (DRN, or 2D-TAN for a TANModelConfig) with seeded
    random weights, on `device` (cuda by default). `ops=PLAIN_OPS` builds
    the DRN from the kernels' plain versions, the one the kernels' model is
    held against on the card (2D-TAN has no `ops`: its map-conv epilogue
    runs its plain version on a CPU tensor).
    GloVe mode: `pretrained_embeddings` (the vocab's table) fill the
    embedding, frozen, and its row count replaces `model.vocab_size`."""
    dev = resolve_device(device)
    mcfg = cfg.model
    if pretrained_embeddings is not None:
        mcfg = dataclasses.replace(
            mcfg, vocab_size=pretrained_embeddings.shape[0])
    frozen = pretrained_embeddings is not None
    if architecture(cfg) == "2d-tan":
        model = init_parameters(TAN(mcfg, cfg.data.num_clips, frozen), seed)
    else:
        model = init_parameters(DRN(mcfg, base_len=cfg.data.num_clips,
                                    ops=ops, freeze_embeddings=frozen), seed)
    if pretrained_embeddings is not None:
        with torch.no_grad():
            model.query_encoder.embed.weight.copy_(
                torch.as_tensor(pretrained_embeddings, dtype=torch.float32))
    return model.to(dev).eval()


def batch_features(batch: Dict[str, torch.Tensor],
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batch's features: its own, or its rows of the staged table
    (data/staging.py), gathered on the table's device."""
    if "features" in batch:
        return batch["features"]
    return table.index_select(0, batch["video_row"].long())


def make_eval_step(cfg: ExperimentConfig, model: DRN):
    """step(batch of device tensors, staged table or None) → (counts,
    n_valid, segments in seconds (B, K, 2) in NMS order, keep (B, K), top
    scores (B, K))."""
    e = cfg.eval
    base_len = float(cfg.data.num_clips)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  table: Optional[torch.Tensor] = None):
        with span("eval.step"):
            with span("eval.gather"):
                features = batch_features(batch, table)
            with span("eval.forward"):
                out = model(features, batch["word_ids"], batch["query_mask"])
            with span("eval.post"):
                return post(out, batch)

    def post(out, batch):
        score = torch.sigmoid(out["match_logits"])
        if e.score_use_iou_head and e.score_iou_weight > 0.0:
            iou_s = torch.sigmoid(out["iou_logits"])
            if e.score_iou_weight != 1.0:
                iou_s = iou_s ** e.score_iou_weight
            score = score * iou_s
        # Stable sort: ties go to the lower index, as lax.top_k does
        # (torch.topk promises no tie order on CUDA).
        ranked = torch.sort(score, dim=1, descending=True, stable=True)
        top_scores = ranked.values[:, :e.top_k]
        top_idx = ranked.indices[:, :e.top_k]
        top_segs = torch.gather(out["segments"], 1,
                                top_idx[..., None].expand(-1, -1, 2))
        _, keep, sorted_segs = batched_temporal_nms(
            top_segs, top_scores, e.nms_iou_threshold)
        counts = recall_at_n(sorted_segs, keep, batch["gt_grid"],
                             ns=e.recall_ns, iou_thresholds=e.iou_thresholds,
                             valid=batch["valid"])
        n_valid = batch["valid"].float().sum()
        scale = (batch["duration"] / base_len)[:, None, None]
        return counts, n_valid, sorted_segs * scale, keep, top_scores

    return eval_step


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    with span("to_device"):
        return {k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in batch.items()}


def _refuse_out_of_scope(cfg: ExperimentConfig, mesh: Optional[Mesh],
                        device_features: bool) -> None:
    if not device_features:
        return
    if cfg.data.dataset == "synthetic":
        raise ValueError("device_features reads per-video feature files; "
                         "the synthetic fixture generates features in "
                         "memory")
    if mesh is not None and mesh.world > 1:
        raise NotImplementedError(
            "device_features in a process group of more than one process: "
            "each rank would stage every video for its row blocks; stream "
            "the features instead (ROADMAP.md, multi-GPU)")


def stage_on_device(dataset, device):
    """Stage `dataset`'s videos (data/staging.py) → (the table on
    `device`, the feature-free view). The host copy is dropped."""
    from drn_tpu_torch.data.staging import stage_video_features

    table, view = stage_video_features(dataset)
    return torch.from_numpy(table).to(device), view


def eval_batches(cfg: ExperimentConfig, dataset, device,
                 mesh: Optional[Mesh] = None):
    """The eval loop's batch iterator over `dataset`: in order, at
    eval.batch_size, in worker processes when data.num_workers > 0; with
    a `mesh`, this data rank's block of each batch."""
    return make_batch_iterator(dataset, cfg.data, shuffle=False, seed=0,
                               batch_size=cfg.eval.batch_size,
                               pin_memory=device.type == "cuda",
                               rank=mesh.data_rank if mesh else 0,
                               world=mesh.data_world if mesh else 1)


def eval_counts(cfg: ExperimentConfig, model: DRN, batches, device, *,
                table: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None
                ) -> Tuple[Dict[Tuple[int, float], float], float]:
    """The recall counts and the count of valid queries over an epoch of
    `batches` (this data rank's blocks under a `mesh`), summed over the
    data ranks: every rank returns the same numbers. The counts stay on
    the device through the loop; one fetch at the end."""
    step = make_eval_step(cfg, model)
    totals = None
    epoch = iter(batches.epoch(0))
    while True:
        with span("eval.batch"):
            batch = next(epoch, None)
        if batch is None:
            break
        counts, n_valid, *_ = step(to_device(time_slice(batch, mesh),
                                             device), table)
        if totals is None:
            keys = sorted(counts, key=str)
            totals = torch.stack([n_valid] + [counts[k] for k in keys])
        else:
            totals = totals + torch.stack([n_valid]
                                          + [counts[k] for k in keys])
    if totals is None:
        return {}, 0.0
    with span("eval.fetch"):
        if mesh is not None and mesh.data_group is not None:
            totals = all_sum(totals, mesh.data_group)
        n, *rest = totals.double().cpu().tolist()
    return dict(zip(keys, rest)), n


def evaluate(cfg: ExperimentConfig, model: DRN, dataset=None,
             split: str = "test", *, device=None, mesh: Optional[Mesh] = None,
             device_features: bool = False,
             batches=None,
             table: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Full-split evaluation → {"R@n,IoU=m": percentage, "mIoU": ...}.

    `device_features` stages each unique video's resampled grid in one
    table on `device` before the loop; the host then feeds word ids and
    row indices only. The metrics equal the streamed path's. `batches`
    (`eval_batches` of the split, in place of `dataset` and
    `device_features`) is the caller's and stays open, so a caller that
    evaluates again reuses its worker processes. `table`, with `batches`
    of the view it was staged with (`stage_on_device`), is a staged table
    of the caller's: the loop indexes it as `device_features`' own. Under
    a `mesh` (by
    default the initialised process group's, parallel/mesh.py) each rank
    evaluates its row blocks and every rank returns the whole split's
    metrics."""
    with span("eval.pass"):
        mesh = mesh or current_mesh()
        _refuse_out_of_scope(cfg, mesh, device_features)
        dev = resolve_device(device if device is not None
                             else getattr(mesh, "device", None))
        model.to(dev).eval()
        if mesh is not None and mesh.sharded and model.mesh is not mesh:
            check_axes(mesh.model_axis, mesh.time_axis, mesh.world, cfg)
            model = copy.deepcopy(model)
            shard_model(model, mesh)
        own = batches is None
        if own:
            if table is not None:
                raise ValueError("a staged table needs the `batches` of "
                                 "its view")
            if dataset is None:
                dataset = make_dataset(cfg.data, cfg.model, split=split)
            if device_features:
                table, dataset = stage_on_device(dataset, dev)
            batches = eval_batches(cfg, dataset, dev, mesh)
        try:
            totals, n = eval_counts(cfg, model, batches, dev, table=table,
                                    mesh=mesh)
        finally:
            if own:
                batches.close()
        return {metric_name(k): 100.0 * v / max(n, 1.0)
                for k, v in totals.items()}


def predict(cfg: ExperimentConfig, model: DRN, batch: Dict[str, np.ndarray],
            device=None):
    """Top segments (in seconds when the batch has "duration", else grid
    units), NMS keep mask and scores, as numpy arrays. "gt_grid", "valid"
    and "duration" are each optional."""
    dev = resolve_device(device)
    model.to(dev).eval()
    b = np.asarray(batch["features"]).shape[0]
    full = dict(batch)
    full.setdefault("gt_grid", np.zeros((b, 2), np.float32))
    full.setdefault("valid", np.ones((b,), bool))
    full.setdefault("duration", np.full((b,), float(cfg.data.num_clips),
                                        np.float32))
    _, _, segs, keep, scores = make_eval_step(cfg, model)(to_device(full, dev))
    return segs.cpu().numpy(), keep.cpu().numpy(), scores.cpu().numpy()


def load_params(args, cfg: ExperimentConfig, *, context: str,
                prefer_best: bool = True) -> Dict[str, torch.Tensor]:
    """The parity-schema state_dict a reading CLI was given:
    `args.torch_checkpoint`, or the params of `args.checkpoint_dir`
    (`utils.checkpoint.restore_params`: the config check, then `best/`
    when `prefer_best` and it holds a step, else the latest step)."""
    if args.torch_checkpoint:
        return load_torch_checkpoint(args.torch_checkpoint)
    return restore_params(
        args.checkpoint_dir, cfg, prefer_best=prefer_best, context=context,
        allow_config_mismatch=getattr(args, "allow_config_mismatch", False))


_DATA_FLAGS = ("feature_dir", "annotation_path", "glove_path", "feature_fps",
               "num_workers")


def with_data_flags(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """`cfg` with the data fields that the CLI's flags of the same names
    set (those the parser has and the user gave)."""
    da = {f: getattr(args, f) for f in _DATA_FLAGS
          if getattr(args, f, None) is not None}
    return cfg.replace(data=dataclasses.replace(cfg.data, **da)) if da else cfg


def main(argv=None):
    p = argparse.ArgumentParser(description="drn_tpu_torch evaluator")
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a directory the port's trainer wrote (or "
                        "tools/orbax_to_pth.py converted)")
    p.add_argument("--torch-checkpoint", default=None,
                   help=".pth in the parity schema")
    p.add_argument("--split", default="test")
    p.add_argument("--feature-dir", default=None)
    p.add_argument("--annotation-path", default=None)
    p.add_argument("--glove-path", default=None)
    p.add_argument("--latest-checkpoint", action="store_true",
                   help="restore the latest step instead of the "
                        "best-on-val checkpoint (the default when "
                        "<checkpoint-dir>/best exists)")
    p.add_argument("--allow-config-mismatch", action="store_true",
                   help="downgrade the checkpoint-vs-active config check "
                        "to a warning")
    p.add_argument("--device-features", action="store_true",
                   help="stage each unique video's resampled features in "
                        "one table on the device before the eval loop "
                        "(V*num_clips*F*4 bytes of device memory)")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    if not args.checkpoint_dir and not args.torch_checkpoint:
        p.error("one of --checkpoint-dir / --torch-checkpoint is required")
    if args.checkpoint_dir and args.torch_checkpoint:
        p.error("--checkpoint-dir and --torch-checkpoint are mutually "
                "exclusive; pass exactly one parameter source")
    device = resolve_device(args.device)  # no card: raise before any read
    cfg = with_data_flags(get_config(args.config), args)
    vocab = build_vocab(cfg.data, cfg.model)
    model = build_model(cfg, device=device,
                        pretrained_embeddings=vocab.embeddings)
    model.load_state_dict(load_params(args, cfg, context="evaluate",
                                      prefer_best=not args.latest_checkpoint))
    dataset = make_dataset(cfg.data, cfg.model, vocab=vocab, split=args.split)
    results = evaluate(cfg, model, dataset, device=device,
                       device_features=args.device_features)
    for k, v in results.items():
        print(f"{k}: {v:.2f}")


if __name__ == "__main__":
    main()
