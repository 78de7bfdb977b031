"""Graceful preemption (port of drn_tpu/utils/preemption.py): SIGTERM →
finish the step → save a checkpoint → exit 75.

Cluster schedulers announce a preemption with SIGTERM and a grace period.
The guard turns the signal into a flag that the trainer polls once per
step (`preempted_at`); the trainer then force-saves {model, optimizer,
step} and `main` exits with `exit_code_for(guard)`, so a rerun (resume is
the config default) continues from that exact step.

In a process group of more than one process (data parallel, parallel/
mesh.py) the processes must stop at the same step: a signal reaches them
at different steps, or reaches one of them alone, and a rank that stopped
early would leave the others waiting in the next step's all-reduce. So
`preempted_at` takes the MAX of the local flags over the group's gloo
side group, on a CPU tensor, at every step boundary: every rank sees the
stop at the first boundary after any rank got the signal (the JAX
package's multi-process regime reaches the same through the coordination
service's sync point). The flags never travel through the card, so the
poll does not wait for the step's kernels.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

from drn_tpu_torch.parallel.mesh import any_rank


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
        """True once the run should stop and save at `step`; in a process
        group, on every rank at the same step (every rank must poll at
        every step boundary)."""
        hit = any_rank(self._flag.is_set())
        if hit:
            self.triggered = True
        return hit


# sysexits.h EX_TEMPFAIL, "temporary failure, retry later": restart loops
# (systemd, Kubernetes) can key resubmission on it.
PREEMPTED_EXIT_CODE = 75


def exit_code_for(guard: Optional[PreemptionGuard]) -> int:
    return PREEMPTED_EXIT_CODE if guard is not None and guard.triggered else 0
