"""Spans of the benchmark's own and the reading of a profiler trace.

`Ranges` opens a `record_function` range around a module's forward (a
forward pre-hook opens it, a forward hook closes it) and around the
optimizer's step (the instance's `step` wrapped), from the benchmark's
files: the program is not edited. Range names: `pb.forward` (the whole
DRN), `pb.<part>` (a submodule), `pb.optimizer`.

`Trace` reads a chrome trace of `torch.profiler`: the device's kernels,
copies and sets, each kernel's launch on the host (the runtime or driver
call with the same correlation id: its thread and time), the ranges, and
the autograd graph's links (a forward op's sequence number is that of the
backward node that differentiates it). A kernel belongs to a range when
its launch lies inside the range on the range's thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BWD_PREFIX = "autograd::engine::evaluate_function: "


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Ranges:
    """`pb.*` ranges on a model's forward, its named parts' forwards, and an
    optimizer's step, while installed."""

    def __init__(self, model, parts: Sequence[str] = (), optimizer=None):
        self.targets = [("pb.forward", model)] + [
            (f"pb.{p}", getattr(model, p)) for p in parts]
        self.optimizer = optimizer
        self.handles = []

    def install(self) -> "Ranges":
        for name, mod in self.targets:
            open_ = []

            def pre(m, args, name=name, open_=open_):
                rf = torch.autograd.profiler.record_function(name)
                rf.__enter__()
                open_.append(rf)

            def post(m, args, out, open_=open_):
                open_.pop().__exit__(None, None, None)

            self.handles += [mod.register_forward_pre_hook(pre),
                             mod.register_forward_hook(post)]
        if self.optimizer is not None:
            inner = self.optimizer.step

            def step(*a, **kw):
                with torch.autograd.profiler.record_function("pb.optimizer"):
                    return inner(*a, **kw)

            self.optimizer.step = step
        return self

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
        if self.optimizer is not None:
            self.optimizer.__dict__.pop("step", None)


class Trace:
    def __init__(self, events: List[dict], window_s: float, steps: int,
                 units: float, launches: Dict[str, int]):
        self.window_s, self.steps, self.units = window_s, steps, units
        self.port_launches = sum(launches.values())
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.launch_of: Dict[int, Tuple[int, float]] = {}
        self.host_copies: Dict[int, List[float]] = defaultdict(list)
        self.ranges: Dict[str, List[Tuple[int, float, float]]] = defaultdict(list)
        self.host: Dict[int, List[dict]] = defaultdict(list)
        self.fwd_seq: List[Tuple[int, float, int]] = []
        self.bwd: Dict[int, List[Tuple[int, float, float]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat"), e.get("args") or {}
            if cat in LAUNCH_CATS:
                if "correlation" in args:
                    self.launch_of[args["correlation"]] = (e["tid"], e["ts"])
            if cat == "user_annotation":
                self.ranges[e["name"]].append(
                    (e["tid"], e["ts"], e["ts"] + e["dur"]))
            if cat in ("cpu_op", "user_annotation", *LAUNCH_CATS):
                self.host[e["tid"]].append(e)
            if cat == "cpu_op" and "Sequence number" in args:
                seq = args["Sequence number"]
                if e["name"].startswith(BWD_PREFIX):
                    self.bwd[seq].append((e["tid"], e["ts"], e["ts"] + e["dur"]))
                else:
                    self.fwd_seq.append((e["tid"], e["ts"], seq))
        # A copy between the host and the device (a batch's, the counts'
        # fetch), by its launch: device-to-device copies are an op's own.
        host_copy = {(e.get("args") or {}).get("correlation")
                     for e in self.device if e["cat"] == "gpu_memcpy"
                     and ("HtoD" in e["name"] or "DtoH" in e["name"])}
        for corr in host_copy:
            if corr in self.launch_of:
                tid, ts = self.launch_of[corr]
                self.host_copies[tid].append(ts)
        for v in self.host_copies.values():
            v.sort()
        fwd = self.ranges.get("pb.forward")
        launches = defaultdict(int)
        for tid, _ in self.launch_of.values():
            launches[tid] += 1
        self.main_tid = fwd[0][0] if fwd else max(
            launches, key=launches.get, default=None)

    # ---------------------------------------------------------- totals
    def launch(self, k: dict) -> Optional[Tuple[int, float]]:
        return self.launch_of.get((k.get("args") or {}).get("correlation"))

    @property
    def busy_s(self) -> float:
        return union_us((e["ts"], e["ts"] + e["dur"])
                        for e in self.device) / 1e6

    @staticmethod
    def ms(kernels: Iterable[dict]) -> float:
        return sum(k["dur"] for k in kernels) / 1e3

    # ---------------------------------------------------- attribution
    def _inside(self, k: dict, spans: List[Tuple[int, float, float]]) -> bool:
        at = self.launch(k)
        return at is not None and any(
            tid == at[0] and s <= at[1] <= e for tid, s, e in spans)

    def in_range(self, name: str) -> List[dict]:
        spans = self.ranges.get(name, [])
        return [k for k in self.kernels if self._inside(k, spans)]

    def outside(self, names: Sequence[str]) -> List[dict]:
        spans = [s for n in names for s in self.ranges.get(n, [])]
        return [k for k in self.kernels if self.launch(k) is not None
                and not self._inside(k, spans)]

    def backward_of(self, name: str) -> List[dict]:
        """Kernels launched by the backward nodes of the ops that ran inside
        range `name`."""
        spans = self.ranges.get(name, [])
        seqs = {seq for tid, ts, seq in self.fwd_seq
                if any(t == tid and s <= ts <= e for t, s, e in spans)}
        nodes = [iv for seq in seqs for iv in self.bwd.get(seq, [])]
        return [k for k in self.kernels if self._inside(k, nodes)]

    def after_forward(self) -> List[dict]:
        """Kernels the main thread launched from the end of each forward to
        its next host-device copy (the next batch's, or the pass's fetch of
        its counts)."""
        spans = []
        copies = self.host_copies.get(self.main_tid, [])
        for tid, _, end in self.ranges.get("pb.forward", []):
            i = bisect.bisect_right(copies, end)
            spans.append((tid, end, copies[i] if i < len(copies)
                          else float("inf")))
        return [k for k in self.kernels if self._inside(k, spans)]

    # ------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by_name[e["name"]] += e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        gaps: Dict[str, float] = defaultdict(float)
        host = sorted(self.host.get(self.main_tid, []), key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        for (_, a), (b, _) in zip(busy, busy[1:]):
            gaps[self._host_at(host, starts, 0.5 * (a + b))] += (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}

    @staticmethod
    def _host_at(host: List[dict], starts: List[float], t: float) -> str:
        """The innermost host event of the main thread at time t."""
        best = None
        i = bisect.bisect_right(starts, t)
        for e in host[max(i - 400, 0):i]:
            if e["ts"] <= t <= e["ts"] + e["dur"]:
                if best is None or e["dur"] <= best["dur"]:
                    best = e
        return best["name"] if best else "host, between ops"


def export_events(prof) -> List[dict]:
    """The session's chrome-trace events, through a file under TMPDIR that
    is removed again."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _session(run, launch_counts, full: bool) -> Trace:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if full:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    before = dict(launch_counts())
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps, units = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = launch_counts()
    return Trace(export_events(prof), wall, steps, units,
                 {k: after[k] - before.get(k, 0) for k in after})


def _per_step(t: Trace) -> float:
    """Kernels a step; 0 for a trace short of the port's own launches."""
    n = len(t.kernels)
    return n / t.steps if n and n >= t.port_launches else 0.0


def traced(run: Callable[[], Tuple[int, float]], launch_counts,
           most: int = 4) -> Tuple[Trace, Trace]:
    """Profile `run()` (→ steps, units of work): → (timing, full).

    `timing` records the device alone (kernels, copies, the runtime's
    launches), which costs the host little: the window's time, busy time
    and kernel count come from it. Sessions are taken until two agree on
    the kernels a step and hold at least the port's own launches
    (`launch_counts()`, before and after): a trace can come back short of
    kernels or empty, and a short one would read as a faster step.
    `full` records the host's ops and the benchmark's ranges too, for
    attribution; it must hold the agreed count. Raises when no two agree
    within `most` sessions of either kind."""
    light: List[Trace] = []
    while True:
        if len(light) == most:
            raise RuntimeError(
                "the traces disagree on the kernels a step: "
                f"{[len(t.kernels) / t.steps for t in light]} (port launches "
                f"{[t.port_launches for t in light]})")
        light.append(_session(run, launch_counts, full=False))
        counts = [_per_step(t) for t in light]
        agreed = [c for c in counts if c and counts.count(c) >= 2]
        if agreed:
            timing = light[counts.index(agreed[0])]
            break
    for _ in range(most):
        full = _session(run, launch_counts, full=True)
        if _per_step(full) >= _per_step(timing):
            return timing, full
    raise RuntimeError(f"no full trace holds the {_per_step(timing)} "
                       "kernels a step of the timing traces")
