"""Checkpoints of the port (port of drn_tpu/utils/checkpoint.py), as
`.pth` files where the JAX package writes Orbax directories:

    <dir>/<step>.pth              {"model", "optimizer", "step"}
    <dir>/best/<step>.pth         {"model", "step", "val_metric"}
    <dir>/experiment_config.json  the config that trained <dir>

"model" is a state_dict in the parity schema (`DRN.state_dict()`), so
`python -m drn_tpu_torch.evaluate --torch-checkpoint <dir>/<step>.pth`
reads any of them, and `--checkpoint-dir <dir>` reads the directory
(`<dir>/best` first, as the JAX CLIs do: `prefer_best_dir`). Writes go to
a temporary file renamed into place, so a reader never sees half a
checkpoint. A step file without "optimizer" (one that
tools/orbax_to_pth.py converted) serves every reader and `--init-from`;
resuming from it raises.

The port reads no Orbax directory (a directory of numeric step
subdirectories): `load_model_state` names the converter instead,
tools/orbax_to_pth.py, which runs where the JAX package is.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import warnings
from typing import Any, Dict, List, Optional

import torch

BEST_SUBDIR = "best"
CONFIG_FILENAME = "experiment_config.json"
CONVERTER = "tools/orbax_to_pth.py"

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
    except (FileNotFoundError, NotADirectoryError):
        return []
    return sorted(int(n[:-4]) for n in names
                  if n.endswith(".pth") and n[:-4].isdigit())


def is_orbax_dir(directory: str) -> bool:
    """True for Orbax's layout: numeric step subdirectories (in
    `directory` or its `best/`)."""
    for d in (directory, os.path.join(directory, BEST_SUBDIR)):
        try:
            if any(n.isdigit() and os.path.isdir(os.path.join(d, n))
                   for n in os.listdir(d)):
                return True
        except (FileNotFoundError, NotADirectoryError):
            continue
    return False


class OrbaxCheckpointError(ValueError):
    """An Orbax checkpoint directory given to the port."""


def step_path(directory: str, step: Optional[int] = None) -> str:
    """`<directory>/<step>.pth`, the latest step when `step` is None.
    FileNotFoundError when there is none (or not that step);
    OrbaxCheckpointError, naming the converter, for an Orbax directory."""
    steps = _steps(directory)
    if not steps and is_orbax_dir(directory):
        raise OrbaxCheckpointError(
            f"{directory!r} is an Orbax checkpoint directory (numeric step "
            "subdirectories), which the port does not read; convert it "
            f"where the JAX package is installed: python {CONVERTER} "
            f"--config <name> --checkpoint-dir {directory} --out <dir>")
    if not steps or (step is not None and step not in steps):
        what = "no checkpoint" if step is None else f"no step {step}"
        raise FileNotFoundError(f"{what} in {directory}")
    return os.path.join(directory, f"{steps[-1] if step is None else step}"
                        ".pth")


def load_model_state(directory: str, step: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """The params-only restore (the JAX package's `partial=True`): the
    "model" state_dict of `directory`'s step (latest by default), whatever
    else the file holds."""
    return torch.load(step_path(directory, step), map_location="cpu",
                      weights_only=True)["model"]


def restore_params(directory: str, cfg: Any, *, prefer_best: bool = True,
                   allow_config_mismatch: bool = False,
                   context: str = "restore") -> Dict[str, torch.Tensor]:
    """What the reading CLIs restore from `--checkpoint-dir`: the config
    check (`check_experiment_config`), then the params of the latest step
    of `<directory>/best` when it has one and `prefer_best`, else of
    `directory`."""
    check_experiment_config(directory, cfg,
                            allow_mismatch=allow_config_mismatch,
                            context=context)
    return load_model_state(prefer_best_dir(directory, prefer=prefer_best))


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

    def restore(self, step: Optional[int] = None
                ) -> Optional[Dict[str, Any]]:
        """Checkpoint `step` (the latest by default), or None when the
        directory holds none; an Orbax directory raises."""
        if (step is None and self.latest_step() is None
                and not is_orbax_dir(self.directory)):
            return None
        return torch.load(step_path(self.directory, step),
                          map_location="cpu", weights_only=True)


class BestCheckpointTracker:
    """The single best-on-val checkpoint under `<directory>/best`; the
    metric is read back on start, so a resumed run does not overwrite a
    better checkpoint with a worse one. An unreadable best (a file that
    does not load, one without "val_metric") is moved aside, whole
    directory and all, to `best.corrupt-N` with a warning: the readers'
    `prefer_best_dir` would otherwise hand it to every evaluation. The
    next evaluation re-anchors the best."""

    def __init__(self, directory: str):
        self.directory = os.path.join(os.path.abspath(directory),
                                      BEST_SUBDIR)
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
                target = self._quarantine()
                warnings.warn(
                    f"best-checkpoint metric restore failed for {path!r} "
                    f"({type(e).__name__}: {e}); moved the directory to "
                    f"{target!r}; the next evaluation re-anchors the best")

    def _quarantine(self) -> str:
        """Rename the best directory to the first free `best.corrupt-N`
        and start an empty one. Race-safe between processes that share
        the directory: a rename whose source is gone lost to a peer (its
        newest `best.corrupt-*` is reported), one whose target is taken
        tries the next N."""
        n = 0
        while True:
            target = f"{self.directory}.corrupt-{n}"
            if os.path.exists(target):
                n += 1
                continue
            try:
                os.rename(self.directory, target)
            except FileNotFoundError:
                peers = glob.glob(glob.escape(self.directory) + ".corrupt-*")
                try:
                    target = max(peers, key=os.path.getmtime)
                except (ValueError, FileNotFoundError):
                    target = f"{self.directory}.corrupt-* (moved by a peer)"
            except OSError:
                n += 1  # a peer took this target first
                continue
            break
        os.makedirs(self.directory, exist_ok=True)
        return target

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


def prefer_best_dir(directory: str, prefer: bool = True) -> str:
    """`<directory>/best` when `prefer` and it holds a checkpoint (a step
    file, or an Orbax step, so that one is refused by name), else
    `directory`."""
    best = os.path.join(directory, BEST_SUBDIR)
    if prefer and (_steps(best) or is_orbax_dir(best)):
        return best
    return directory


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
