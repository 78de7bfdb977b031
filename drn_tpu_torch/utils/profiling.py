"""Profiling and timing (port of drn_tpu/utils/profiling.py).

  * `trace(logdir)`: a `torch.profiler` trace of everything inside the
    block, host and (when there is a card) device activity, written to
    `<logdir>/trace.json` in the chrome trace format (ui.perfetto.dev).
  * `time_fn`: per-call latency, each call synchronised, with the JAX
    package's keys; `throughput` and `host_ms`: pipelined calls, one
    synchronize at the end.
  * `cuda_time_ms`: the device time of one call, from CUDA events around a
    CUDA graph of back-to-back calls (no host overhead in the number).
  * `kernel_events`, `kernel_stats`: the device kernels of a finished
    `torch.profiler` session and their per-call sums (by name, summed, and
    the union of their intervals); `device_time` traces a few calls of a
    function with them. Unlike `cuda_time_ms` it takes any call, one that
    copies from the host included (a CUDA graph cannot capture such a
    copy), and it counts the call's kernels.
  * `span(name)`: the program's own range `drn.<name>` around a layer of
    the eval and train steps, recorded only while a `torch.profiler`
    session is (otherwise one shared no-op context). The ranges land in
    the session's trace beside the device's kernels, on its clock.
    `span_table` reads them back from a chrome trace: the device time of
    the kernels each span launched and the device's idle time under it.

PyTorch on the card returns before the device is done, as JAX's dispatch
does: the host-clock timers here synchronise the card (when CUDA is in
use) where the JAX package calls `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


SPAN_PREFIX = "drn."
# The main thread waits inside `.backward()` while autograd's own thread
# launches the backward's kernels: a launch on any thread inside this span
# is the span's.
ANY_THREAD_SPANS = ("drn.train.backward",)
_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records the range `drn.<name>` while a profiler
    session records, and costs one check otherwise (the shared no-op
    context: no allocation, no `record_function`)."""
    if not _profiling():
        return _NO_SPAN
    return torch.autograd.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block into `logdir`/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _sync()
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def time_fn(fn: Callable[..., Any], *args, iters: int = 20, warmup: int = 2,
            **kw) -> Dict[str, float]:
    """Times `fn(*args)`, each call synchronised on its own.

    Returns {"mean_ms", "median_ms", "min_ms", "iters"}: per-call latency
    after `warmup` calls (for pipelined throughput see `throughput`)."""
    for _ in range(warmup):
        fn(*args, **kw)
        _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    return {
        "mean_ms": statistics.fmean(samples),
        "median_ms": statistics.median(samples),
        "min_ms": min(samples),
        "iters": float(iters),
    }


def throughput(fn: Callable[..., Any], *args, items_per_call: int,
               iters: int = 20, warmup: int = 2, **kw) -> float:
    """Pipelined items/s: `iters` calls, one synchronize at the end."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _sync()
    return items_per_call * iters / (time.perf_counter() - t0)


def host_ms(fn: Callable[[], Any], iters: int) -> float:
    """Host clock per call of `fn()` over `iters` pipelined calls, after 3
    warm-ups."""
    return 1e3 / throughput(fn, items_per_call=1, iters=iters, warmup=3)


def cuda_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one `fn()`: a CUDA graph of `iters` back-to-back
    calls, replayed `reps` times between CUDA events; the median replay
    over `iters`. (The graph keeps host overhead out of the number.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[len(times) // 2]


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def kernel_events(prof, path: Optional[str] = None) -> List[dict]:
    """The device kernels (chrome-trace events of category `kernel`: name,
    `ts` and `dur` in µs) of a finished `torch.profiler.profile` session.
    Its chrome trace is written to `path`, or to a temporary file that is
    removed again."""
    if path is not None:
        prof.export_chrome_trace(path)
        return _kernels_of(path)
    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        return _kernels_of(tmp)
    finally:
        os.unlink(tmp)


def _kernels_of(path: str) -> List[dict]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def kernel_stats(kernels: List[dict], calls: int) -> Dict[str, Any]:
    """Per call of `calls`: the kernels launched, their summed time
    (`kernel_ms`), the time at least one ran (`busy_ms`, the union of
    their intervals; the step's rest is the device's idle time), and
    `by_name`: [name, launches, ms] per call, the longest first."""
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    return {
        "kernels": len(kernels) / calls,
        "kernel_ms": sum(e["dur"] for e in kernels) / 1e3 / calls,
        "busy_ms": union_us((e["ts"], e["ts"] + e["dur"])
                            for e in kernels) / 1e3 / calls,
        "by_name": [[k, n / calls, us / 1e3 / calls] for k, (n, us) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])],
    }


def device_time(fn: Callable[[], Any], calls: int = 3, warmup: int = 1,
                path: Optional[str] = None,
                sessions: int = 1) -> Dict[str, Any]:
    """`kernel_stats` of `calls` back-to-back calls of `fn()` on the card,
    from a `torch.profiler` trace taken after `warmup` calls (its chrome
    trace kept at `path` when given). Raises when the traces hold no
    kernel: the call ran nothing on the card.

    With `sessions` > 1, that many traces are taken, and more, up to
    twice as many, until two hold the most kernels any held: a trace can
    come back short of kernels, or empty (on an H100, 5 of the 143 traces
    of one run of chip_smoke's module probes, one of them empty), and a
    short one would read as a faster call. A trace can also hold a
    one-off kernel more than the others (on an H100, one of six traces of
    the plain-version eval step held 1,202 kernels against 1,201): when
    no two traces agree on the most, the most that two agree on is kept.
    The result is the median by kernel time of the traces that hold the
    count kept, with `traces`, the kernels a call of every trace taken."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    taken = []
    while len(taken) < 2 * sessions:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        taken.append(kernel_stats(kernel_events(prof, path), calls))
        most = max(t["kernels"] for t in taken)
        full = [t for t in taken if t["kernels"] == most]
        if len(taken) >= sessions and (len(full) >= 2 or sessions == 1):
            break
    counts = [t["kernels"] for t in taken]
    if not most:
        raise RuntimeError("the profiler recorded no kernel on the card")
    if len(full) < 2 and sessions > 1:
        agreed = [n for n in counts if n and counts.count(n) >= 2]
        if not agreed:
            raise RuntimeError(f"the profiler's traces disagree on the "
                               f"kernels a call: {counts}")
        full = [t for t in taken if t["kernels"] == max(agreed)]
    full.sort(key=lambda t: t["kernel_ms"])
    return {**full[len(full) // 2], "traces": counts}


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(ranges: Iterable[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """Nested (start, end, name) ranges of one thread → the pieces of their
    union in time order, each with the innermost range open over it."""
    pieces, stack, t = [], [], 0.0
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, n = stack.pop()
            pieces.append((t, end, n))
            t = end
        if stack:
            pieces.append((t, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, name))
        t = s
    while stack:
        end, n = stack.pop()
        pieces.append((t, end, n))
        t = end
    return [p for p in pieces if p[1] > p[0]]


def _overlap_by_name(intervals: Iterable[Tuple[float, float]],
                    pieces: List[Tuple[float, float, str]]
                    ) -> Dict[str, float]:
    """The time of sorted, disjoint `intervals` under each name of sorted,
    disjoint `pieces`."""
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in intervals:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, n = pieces[k]
            out[n] += min(b, e) - max(a, s)
            k += 1
    return dict(out)


def _idle_gaps(busy: Iterable[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The pieces of [start, end] outside every busy interval, in order."""
    gaps, t = [], start
    for s, e in sorted(busy):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


def span_table(events: List[dict], steps: int) -> Dict[str, Any]:
    """The program's spans in a chrome trace of `steps` steps (a profiler
    session that recorded the host and the device), a step each, all from
    this one trace:

      window_ms   from the first span or device operation to the last
      busy_ms     the union of kernels, copies and sets in the window
      spans       name → calls; device_ms, kernels launched inside the
                  span (its children's included); self_ms, those whose
                  innermost span it is; idle_ms, the device's idle time
                  while it was the innermost span open on the main thread
                  (the one that opened the most spans)
      outside     the same two of the kernels and idle time under no span

    A launch is a span's when it lies inside it on the span's thread; a
    launch on a thread with no span open over it (autograd's) is that of
    the `ANY_THREAD_SPANS` span open over it, on that span's thread."""
    launch, device = {}, []
    ranges: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in _LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in _DEVICE_CATS:
            device.append(e)
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    if not ranges:
        raise RuntimeError("the trace holds no span of the program")
    main = max(ranges, key=lambda tid: len(ranges[tid]))
    crossing = [(tid, s, e) for tid, v in ranges.items() for s, e, n in v
                if n in ANY_THREAD_SPANS]
    rows = defaultdict(lambda: {"calls": 0.0, "device_ms": 0.0,
                                "self_ms": 0.0, "idle_ms": 0.0})
    outside = {"self_ms": 0.0, "idle_ms": 0.0}
    for v in ranges.values():
        for _, _, n in v:
            rows[n]["calls"] += 1.0 / steps
    for k in device:
        at = launch.get((k.get("args") or {}).get("correlation"))
        if k["cat"] != "kernel" or at is None:
            continue
        tid, ts = at
        if not any(s <= ts <= e for s, e, _ in ranges.get(tid, ())):
            tid = next((t for t, s, e in crossing if s <= ts <= e), tid)
        open_ = [(s, e, n) for s, e, n in ranges.get(tid, ())
                 if s <= ts <= e]
        ms = k["dur"] / 1e3 / steps
        for _, _, n in open_:
            rows[n]["device_ms"] += ms
        if open_:
            rows[max(open_, key=lambda r: (r[0], -r[1]))[2]]["self_ms"] += ms
        else:
            outside["self_ms"] += ms
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    start = min([s for s, _ in busy] + [s for s, _, _ in ranges[main]])
    end = max([e for _, e in busy] + [e for _, e, _ in ranges[main]])
    gaps = _idle_gaps(busy, start, end)
    under = _overlap_by_name(gaps, _innermost(ranges[main]))
    for n, us in under.items():
        rows[n]["idle_ms"] = us / 1e3 / steps
    outside["idle_ms"] = (sum(b - a for a, b in gaps)
                          - sum(under.values())) / 1e3 / steps
    return {"window_ms": (end - start) / 1e3 / steps,
            "busy_ms": union_us(busy) / 1e3 / steps,
            "spans": {n: rows[n] for n in sorted(rows)},
            "outside": outside}
