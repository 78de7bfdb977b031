"""Graceful preemption (port of drn_tpu/utils/preemption.py): SIGTERM →
finish the step → save a checkpoint → exit 75.

Cluster schedulers announce a preemption with SIGTERM and a grace period.
The guard turns the signal into a flag that the trainer polls once per
step (`preempted_at`); the trainer then force-saves {model, optimizer,
step} and `main` exits with `exit_code_for(guard)`, so a rerun (resume is
the config default) continues from that exact step.

One process only. The JAX package's multi-process regime (every process
agreeing on the step through the coordination service's sync point) has
no counterpart here until the port runs data parallel: a guard installed
in a `torch.distributed` group of more than one process raises.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

import torch


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class PreemptionGuard:
    """Install with `install()` (or as a context manager); poll
    `preempted_at(step)` once per training step; `triggered` stays True
    after a hit so callers can report the stop after the loop."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: dict = {}
        self.triggered = False
        self.installed = False

    def install(self) -> "PreemptionGuard":
        """Chain the flag-setter in front of any existing handler. Signal
        handlers work in the main thread only: elsewhere (a train() driven
        from another thread) the guard never triggers rather than crash."""
        if _world_size() > 1:
            raise NotImplementedError(
                "PreemptionGuard in a process group of world size > 1: "
                "the processes must agree on the step to stop at, which "
                "needs the port's data-parallel path (ROADMAP.md)")
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:  # not the main thread
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(signum)
        if callable(prev):  # keep a pre-existing Python handler working
            prev(signum, frame)

    def preempted_at(self, step: int) -> bool:
        """True once the run should stop and save at `step`."""
        hit = self._flag.is_set()
        if hit:
            self.triggered = True
        return hit


# sysexits.h EX_TEMPFAIL, "temporary failure, retry later": restart loops
# (systemd, Kubernetes) can key resubmission on it.
PREEMPTED_EXIT_CODE = 75


def exit_code_for(guard: Optional[PreemptionGuard]) -> int:
    return PREEMPTED_EXIT_CODE if guard is not None and guard.triggered else 0
