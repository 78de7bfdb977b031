"""AOT export of the eval step (port of drn_tpu/export.py): torch.export.

The whole inference step (forward → decode → score → top-k → temporal NMS
→ recall counts → seconds scaling) becomes one `torch.export`
ExportedProgram, saved as a `.pt2` beside a JSON sidecar. A serving host
loads it with `load_exported` and calls it without this package's model
code or config registry: torch, and `drn_tpu_torch.ops.cuda` (which
registers the kernels' custom ops and builds them from `csrc/` with nvcc
at their first launch).

On the card the graph holds each kernel launch as one opaque custom op
node (`torch.ops.drn_tpu_torch.fused_stem`, `.fused_fusion_block`,
`.conv_ln_relu`); on the CPU the kernels' plain versions are traced into
aten ops. The artifact runs on the one device it was exported for (the
sidecar's `device`), as the JAX artifact runs on its `platforms`.

Parameters stay an argument: `call(params, batch)` takes a state_dict in
the parity schema (`DRN.state_dict()`, a `.pth`), mapped onto the graph's
parameter names through the sidecar, so one artifact serves every
checkpoint of its config.

CLI:
    python -m drn_tpu_torch.export --config charades_c3d --batch-size 48 \\
        --torch-checkpoint m.pth --out drn.pt2 [--device cpu]

`--checkpoint-dir` reads the LATEST step of a checkpoint directory of the
port, not its `best/`, as the JAX exporter does.
"""

from __future__ import annotations

import argparse
import json
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from drn_tpu_torch.ops.metrics import metric_name

OUTPUTS = ("recall_counts", "n_valid", "segments_seconds", "nms_keep",
           "scores")


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def batch_spec(cfg, batch_size: Optional[int] = None) -> Dict[str, Spec]:
    """The eval-step input contract at a fixed batch size (static shapes)."""
    b = batch_size or cfg.eval.batch_size
    t, f = cfg.data.num_clips, cfg.model.feature_dim
    l = cfg.data.max_query_len
    return {
        "features": Spec((b, t, f), torch.float32),
        "word_ids": Spec((b, l), torch.int32),
        "query_mask": Spec((b, l), torch.bool),
        "gt_grid": Spec((b, 2), torch.float32),
        "duration": Spec((b,), torch.float32),
        "valid": Spec((b,), torch.bool),
    }


class EvalStep(torch.nn.Module):
    """`evaluate.make_eval_step` as a module of the batch's tensors → the
    output dict, recall counts keyed by `metric_name`."""

    def __init__(self, cfg, model):
        from drn_tpu_torch.evaluate import make_eval_step

        super().__init__()
        self.model = model
        self._step = make_eval_step(cfg, model)

    def forward(self, features, word_ids, query_mask, gt_grid, duration,
                valid):
        counts, n_valid, segs, keep, scores = self._step(dict(
            features=features, word_ids=word_ids, query_mask=query_mask,
            gt_grid=gt_grid, duration=duration, valid=valid))
        return {
            "recall_counts": {metric_name(k): v for k, v in counts.items()},
            "n_valid": n_valid,
            "segments_seconds": segs,
            "nms_keep": keep,
            "scores": scores,
        }


def export_eval_step(cfg, model, batch_size: Optional[int] = None,
                     device=None) -> Tuple[torch.export.ExportedProgram,
                                           Dict[str, Any]]:
    """Export the eval step of `model` on `device` (cuda unless the caller
    asks for the CPU); returns (ExportedProgram, sidecar). The weights are
    traced as the program's parameters; `load_exported`'s callable takes
    others of the same schema."""
    from drn_tpu_torch.config import require_drn
    from drn_tpu_torch.evaluate import resolve_device

    require_drn(cfg, "export")
    dev = resolve_device(device)
    model.to(dev).eval()
    spec = batch_spec(cfg, batch_size)
    example = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
               for k, s in spec.items()}
    example["query_mask"][:, 0] = True
    with torch.no_grad(), warnings.catch_warnings():
        # nn.LSTM re-assigns its _flat_weights list while it is traced; the
        # weights themselves are the program's parameters.
        warnings.filterwarnings("ignore", message=".*_flat_weights")
        ep = torch.export.export(EvalStep(cfg, model), (), kwargs=example)
    sidecar = {
        "config": cfg.name,
        "batch": {k: [list(s.shape), str(s.dtype).removeprefix("torch.")]
                  for k, s in sorted(spec.items())},
        "outputs": list(OUTPUTS),
        "device": str(dev),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "top_k": cfg.eval.top_k,
        "nms_iou_threshold": cfg.eval.nms_iou_threshold,
        "score_use_iou_head": cfg.eval.score_use_iou_head,
        "score_iou_weight": cfg.eval.score_iou_weight,
        # parity-schema name → the program's name of the same tensor
        "params": {k: f"model.{model.owner(k)}.{k}"
                   for k in model.state_dict()},
    }
    return ep, sidecar


def save_exported(ep: torch.export.ExportedProgram, sidecar: Dict[str, Any],
                  path: str) -> None:
    torch.export.save(ep, path)
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)


def load_exported(path: str) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact; returns (call, sidecar). `call(params, batch)`
    takes a parity-schema state_dict (or None: the weights it holds, those
    it was exported with until a call passes others) and the batch's
    arrays or tensors, and returns the output dict on the artifact's
    device. It needs torch and the kernels' package alone: no model code,
    no config."""
    import drn_tpu_torch.ops.cuda  # noqa: F401  (registers the custom ops)

    with open(path + ".json") as f:
        sidecar = json.load(f)
    module = torch.export.load(path).module()
    device = torch.device(sidecar["device"])
    names = sidecar["params"]
    loaded = []  # the (tensor, version) pairs the module holds

    def load(params: Dict[str, torch.Tensor]) -> None:
        unknown = sorted(set(params) - set(names))
        missing = sorted(set(names) - set(params))
        if unknown or missing:
            raise KeyError(f"params outside the artifact's schema "
                           f"{unknown[:5]}, missing {missing[:5]}")
        now = [(params[k], params[k]._version) for k in names]
        if len(now) == len(loaded) and all(
                a is b and u == v for (a, u), (b, v) in zip(now, loaded)):
            return  # the same tensors, unchanged: nothing to copy
        module.load_state_dict({names[k]: params[k].to(device)
                                for k in names}, strict=False, assign=True)
        loaded[:] = now

    def call(params: Optional[Dict[str, torch.Tensor]],
             batch: Dict[str, Any]) -> Dict[str, Any]:
        if params is not None:
            load(params)
        with torch.no_grad():
            return module(**{k: torch.as_tensor(v, device=device)
                             for k, v in batch.items()})

    return call, sidecar


def main(argv=None):
    p = argparse.ArgumentParser(description="drn_tpu_torch AOT exporter")
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a checkpoint directory of the port: its latest "
                        "step (best/ is not preferred)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="optional .pth in the parity schema: the weights "
                        "traced into the artifact (shapes match either way)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--glove-path", default=None)
    p.add_argument("--annotation-path", default=None,
                   help="GloVe mode: dataset annotations that fix the "
                        "(filtered) vocab, hence the embedding-table shape")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None,
                   help="the one torch device the artifact runs on; cuda "
                        "when omitted")
    args = p.parse_args(argv)
    if args.checkpoint_dir and args.torch_checkpoint:
        p.error("--checkpoint-dir and --torch-checkpoint are mutually "
                "exclusive; pass at most one parameter source")

    from drn_tpu_torch.config import get_config, require_drn
    from drn_tpu_torch.convert import load_torch_checkpoint
    from drn_tpu_torch.data.pipeline import build_vocab
    from drn_tpu_torch.evaluate import (build_model, resolve_device,
                                        with_data_flags)
    from drn_tpu_torch.utils.checkpoint import load_model_state

    device = resolve_device(args.device)  # no card: raise before any read
    cfg = with_data_flags(get_config(args.config), args)
    require_drn(cfg, "export")
    # The vocab sizes the embedding table; without it a GloVe-trained
    # checkpoint would never fit the exported parameters.
    vocab = build_vocab(cfg.data, cfg.model)
    model = build_model(cfg, device=device,
                        pretrained_embeddings=vocab.embeddings)
    if args.torch_checkpoint:
        model.load_state_dict(load_torch_checkpoint(args.torch_checkpoint))
    elif args.checkpoint_dir:
        model.load_state_dict(load_model_state(args.checkpoint_dir))
    ep, sidecar = export_eval_step(cfg, model, args.batch_size, device)
    save_exported(ep, sidecar, args.out)
    print(f"exported {cfg.name} -> {args.out} (device={sidecar['device']}, "
          f"batch={sidecar['batch']['features'][0][0]})")


if __name__ == "__main__":
    main()
