"""Convert a checkpoint directory of the JAX package (Orbax) into one the
PyTorch port reads: the inverse of `python -m drn_tpu.parity.convert`.

    python tools/orbax_to_pth.py --config charades_c3d \\
        --checkpoint-dir /ckpt/charades_c3d/stage1 --out /ckpt_pth/stage1 \\
        [--glove-path G --annotation-path A]

Runs where the JAX package is installed (JAX, Orbax, torch): it restores
the params alone (`drn_tpu.utils.checkpoint.CheckpointManager`, a partial
restore into the config's parameter tree) and converts them with
`drn_tpu_torch.convert.flax_params_to_state_dict`. It writes

    <out>/<step>.pth              {"model", "step"}: the latest step
    <out>/best/<step>.pth         {"model", "step", "val_metric"}, when the
                                  source has a best-on-val checkpoint
    <out>/experiment_config.json  the source's, copied

in that order. The step files hold no optimizer state, so the port's
evaluate, infer, serve and export and `train --init-from` read them, and a
`train` resume from them raises. GloVe-mode checkpoints need the run's
`--glove-path` and `--annotation-path`: they fix the embedding's shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restore(directory: str, template, with_metric=False):
    """{"params"[, "val_metric"]} of `directory`'s step (latest by
    default), host numpy leaves; None when the directory has no step."""
    import jax

    from drn_tpu.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory)
    try:
        step = mgr.latest_step()
        if step is None:
            return None, None
        want = {"params": template}
        if with_metric:
            want["val_metric"] = 0.0
        restored = mgr.restore(want, step=step, partial=True)
    finally:
        mgr.close()
    return jax.device_get(restored), step


def _save(obj, path: str) -> None:
    import torch

    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--checkpoint-dir", required=True,
                   help="the JAX package's Orbax checkpoint directory")
    p.add_argument("--out", required=True,
                   help="the port's checkpoint directory to write")
    p.add_argument("--glove-path", default=None)
    p.add_argument("--annotation-path", default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from drn_tpu.config import get_config
    from drn_tpu.data.pipeline import build_vocab
    from drn_tpu.train import build_model, init_params
    from drn_tpu.utils.checkpoint import BEST_SUBDIR, CONFIG_FILENAME
    from drn_tpu_torch.convert import flax_params_to_state_dict

    cfg = get_config(args.config)
    da = {k: getattr(args, k) for k in ("glove_path", "annotation_path")
          if getattr(args, k)}
    if da:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **da))
    vocab = build_vocab(cfg.data, cfg.model)
    model = build_model(cfg, pretrained_embeddings=vocab.embeddings)
    template = jax.device_get(init_params(cfg, model, jax.random.key(0)))

    restored, step = _restore(args.checkpoint_dir, template)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {args.checkpoint_dir}")
    _save({"model": flax_params_to_state_dict(restored["params"], cfg.model),
           "step": step}, os.path.join(args.out, f"{step}.pth"))
    wrote = [f"{step}.pth"]

    best_dir = os.path.join(args.checkpoint_dir, BEST_SUBDIR)
    if os.path.isdir(best_dir):
        best, best_step = _restore(best_dir, template, with_metric=True)
        if best is not None:
            _save({"model": flax_params_to_state_dict(best["params"],
                                                       cfg.model),
                   "step": best_step,
                   "val_metric": float(best["val_metric"])},
                  os.path.join(args.out, BEST_SUBDIR, f"{best_step}.pth"))
            wrote.append(f"{BEST_SUBDIR}/{best_step}.pth")

    src_cfg = os.path.join(args.checkpoint_dir, CONFIG_FILENAME)
    if os.path.exists(src_cfg):
        shutil.copyfile(src_cfg, os.path.join(args.out, CONFIG_FILENAME))
        wrote.append(CONFIG_FILENAME)
    print(f"wrote {args.out}: {', '.join(wrote)}")


if __name__ == "__main__":
    main()
