"""Numerical sanitizers (port of drn_tpu/utils/debug.py).

  * `nan_debug()`: context manager turning on autograd's anomaly mode
    (`torch.autograd.set_detect_anomaly`): a backward op that returns NaN
    raises at once, naming the op and showing the forward call that made
    it. (JAX's `jax_debug_nans` re-checks the forward ops as well; eager
    PyTorch leaves a NaN in the forward to `assert_finite_tree` and
    `check_metrics`.) Slow; for debugging runs, not production.
  * `assert_finite_tree(tree)`: host-side check of params, grads, metrics
    or a `state_dict`.
  * `check_metrics(metrics, step)`: cheap per-step guard for the train
    loop; raises with the offending keys.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Anomaly mode with NaN checks inside the block; the previous mode is
    restored on exit."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of nested dicts, lists and tuples, the path written as
    JAX's `keystr` writes it: ['key'][0]..."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _finite(leaf: Any) -> bool:
    """False for a floating leaf (tensor, array or number) holding NaN or
    Inf; integer and boolean leaves are always finite."""
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return (not np.issubdtype(arr.dtype, np.floating)
            or bool(np.all(np.isfinite(arr))))


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming every non-finite leaf."""
    bad = [p for p, leaf in _leaves_with_path(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def check_metrics(metrics: Dict[str, Any], step: int) -> None:
    """Train-loop guard: fail fast (with step number) on NaN/Inf metrics."""
    bad = [k for k, v in metrics.items() if not _finite(v)]
    if bad:
        raise FloatingPointError(
            f"non-finite training metrics at step {step}: {bad}"
        )
