"""Faults planted underneath the timed path, to show that the comparison
catches them: each is a context manager that patches the program's
module for the length of a run (the program's files are not touched).

  eval:  alter   one recall count of every step off by one, where the
                 step produces it
         half    half of every batch left out (its rows marked invalid),
                 the metrics taken over the rest
  train: frozen  the optimizer's step returns the state unchanged
         half    half of every batch left out, the loss's mean taken over
                 the rest
         leaf    one leaf's gradient doubled where the backward produces it
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name: str, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _half(to_device):
    def half(batch, device):
        batch = dict(batch)
        valid = batch["valid"].copy()
        valid[len(valid) // 2:] = False
        batch["valid"] = valid
        return to_device(batch, device)
    return half


def _alter(recall_at_n):
    def altered(*a, **kw):
        counts = recall_at_n(*a, **kw)
        key = sorted(counts, key=str)[0]
        counts[key] = counts[key] + 1.0
        return counts
    return altered


def _leaf(loss_and_grads):
    def doubled(cfg, model, batch, table=None):
        metrics = loss_and_grads(cfg, model, batch, table)
        p = getattr(model, "module", model).backbone.stem.conv.weight
        if p.grad is not None:
            p.grad.mul_(2.0)
        return metrics
    return doubled


def _frozen(step):
    def frozen(self):
        return True
    return frozen


def plant(kind: str, entry: str):
    """The context manager of fault `kind` for an `entry`'s run."""
    from drn_tpu_torch import evaluate, train

    if (entry, kind) == ("eval_split", "alter"):
        return patched(evaluate, "recall_at_n", _alter)
    if kind == "half":
        return patched(evaluate, "to_device", _half)
    if (entry, kind) == ("train", "leaf"):
        return patched(train, "loss_and_grads", _leaf)
    if (entry, kind) == ("train", "frozen"):
        return patched(train.Optimizer, "step", _frozen)
    raise KeyError(f"no fault {kind!r} for {entry!r}")


FAULTS = {"eval_split": ("alter", "half"), "train": ("frozen", "half", "leaf")}

