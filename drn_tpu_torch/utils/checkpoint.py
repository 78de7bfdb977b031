"""Checkpoints of the port: the part of drn_tpu/utils/checkpoint.py the
trainer needs, as `.pth` files where the JAX package writes Orbax
directories (reading Orbax checkpoints is queued in ROADMAP.md).

    <dir>/<step>.pth              {"model", "optimizer", "step"}
    <dir>/best/<step>.pth         {"model", "step", "val_metric"}
    <dir>/experiment_config.json  the config that trained <dir>

"model" is a state_dict in the parity schema (`DRN.state_dict()`), so
`python -m drn_tpu_torch.evaluate --torch-checkpoint <dir>/<step>.pth`
reads any of them. Writes go to a temporary file renamed into place, so a
reader never sees half a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Any, Dict, List, Optional

import torch

BEST_SUBDIR = "best"
CONFIG_FILENAME = "experiment_config.json"

# Parity-relevant config fields, as the JAX package's: everything under
# `model` except the scheduling knobs, and the data fields that fix the
# input grid. A checkpoint restored under other values would load and
# silently decode wrong.
_PARITY_EXCLUDE = {"use_pallas_fusion", "use_pallas_conv_blocks",
                   "use_pallas_stem", "iou_fold_mix_min_locations"}
_PARITY_DATA = ("dataset", "feature_type", "num_clips", "max_query_len")


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: str) -> List[int]:
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n[:-4]) for n in names
                  if n.endswith(".pth") and n[:-4].isdigit())


class CheckpointManager:
    """Step checkpoints in one directory: save every
    `save_interval_steps` (or when forced), keep the newest `keep`,
    restore the latest."""

    def __init__(self, directory: str, keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = directory
        self.keep = keep
        self.interval = max(save_interval_steps, 1)
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        return (step % self.interval == 0
                and (latest is None or step > latest))

    def save(self, step: int, state: Dict[str, Any],
             force: bool = False) -> bool:
        if step in self.all_steps() or not (force or self.should_save(step)):
            return False
        _atomic_save(state, os.path.join(self.directory, f"{step}.pth"))
        for old in self.all_steps()[:-self.keep]:
            os.remove(os.path.join(self.directory, f"{old}.pth"))
        return True

    def restore(self) -> Optional[Dict[str, Any]]:
        """The latest checkpoint, or None."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, f"{step}.pth"),
                          map_location="cpu", weights_only=True)


class BestCheckpointTracker:
    """The single best-on-val checkpoint under `<directory>/best`; the
    metric is read back on start, so a resumed run does not overwrite a
    better checkpoint with a worse one. An unreadable one is warned about
    and replaced by the next best."""

    def __init__(self, directory: str):
        self.directory = os.path.join(directory, BEST_SUBDIR)
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric: Optional[float] = None
        steps = _steps(self.directory)
        if steps:
            path = os.path.join(self.directory, f"{steps[-1]}.pth")
            try:
                m = float(torch.load(path, map_location="cpu",
                                     weights_only=True)["val_metric"])
                self.best_metric = m if math.isfinite(m) else None
            except Exception as e:  # noqa: BLE001: any unreadable file
                warnings.warn(f"best checkpoint {path!r} is unreadable "
                              f"({type(e).__name__}: {e}); the next "
                              "evaluation replaces it")

    def update(self, step: int, model_state: Dict[str, torch.Tensor],
               val_metric: float) -> bool:
        """Save iff `val_metric` is finite and beats the best so far."""
        m = float(val_metric)
        if not math.isfinite(m) or (self.best_metric is not None
                                    and m <= self.best_metric):
            return False
        self.best_metric = m
        _atomic_save({"model": model_state, "step": step, "val_metric": m},
                     os.path.join(self.directory, f"{step}.pth"))
        for old in _steps(self.directory):
            if old != step:
                os.remove(os.path.join(self.directory, f"{old}.pth"))
        return True


def prefer_best_dir(directory: str) -> str:
    """`<directory>/best` when it holds a checkpoint, else `directory`."""
    best = os.path.join(directory, BEST_SUBDIR)
    return best if _steps(best) else directory


def _jsonable(cfg: Any) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def save_experiment_config(directory: str, cfg: Any) -> None:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CONFIG_FILENAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"name": cfg.name, **_jsonable(cfg)}, f, indent=1,
                  sort_keys=True)
    os.replace(tmp, path)


def load_experiment_config(directory: str) -> Optional[dict]:
    """The config saved with a checkpoint directory (a `best/` directory
    reads its parent's), or None."""
    candidates = [directory]
    if os.path.basename(os.path.normpath(directory)) == BEST_SUBDIR:
        candidates.append(os.path.dirname(os.path.normpath(directory)))
    for d in candidates:
        try:
            with open(os.path.join(d, CONFIG_FILENAME)) as f:
                return json.load(f)
        except FileNotFoundError:
            continue
    return None


def config_parity_diffs(saved: dict, cfg: Any) -> List[str]:
    """Parity-relevant differences between a saved config and `cfg`."""
    active = _jsonable(cfg)
    diffs = []
    s, a = saved.get("model", {}), active["model"]
    for k in sorted(set(s) & set(a) - _PARITY_EXCLUDE):
        if s[k] != a[k]:
            diffs.append(f"model.{k}: checkpoint={s[k]!r} active={a[k]!r}")
    s, a = saved.get("data", {}), active["data"]
    for k in _PARITY_DATA:
        if k in s and s[k] != a[k]:
            diffs.append(f"data.{k}: checkpoint={s[k]!r} active={a[k]!r}")
    return diffs


def check_experiment_config(directory: str, cfg: Any, *,
                            allow_mismatch: bool = False,
                            context: str = "restore") -> List[str]:
    """Raise when `directory` was trained under a parity-different config
    (a warning with `allow_mismatch`); a directory without a saved config
    passes."""
    saved = load_experiment_config(directory)
    diffs = config_parity_diffs(saved, cfg) if saved is not None else []
    if diffs:
        msg = (f"checkpoint in {directory!r} was trained under another "
               f"parity-relevant config ({context}):\n  " + "\n  ".join(diffs)
               + "\nPass --allow-config-mismatch to proceed anyway.")
        if not allow_mismatch:
            raise ValueError(msg)
        warnings.warn(msg)
    return diffs
