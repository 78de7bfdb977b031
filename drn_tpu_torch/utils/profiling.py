"""Profiling and timing (port of drn_tpu/utils/profiling.py).

  * `trace(logdir)`: a `torch.profiler` trace of everything inside the
    block, host and (when there is a card) device activity, written to
    `<logdir>/trace.json` in the chrome trace format (ui.perfetto.dev).
  * `time_fn`: per-call latency, each call synchronised, with the JAX
    package's keys; `throughput` and `host_ms`: pipelined calls, one
    synchronize at the end.
  * `cuda_time_ms`: the device time of one call, from CUDA events around a
    CUDA graph of back-to-back calls (no host overhead in the number).

PyTorch on the card returns before the device is done, as JAX's dispatch
does: the host-clock timers here synchronise the card (when CUDA is in
use) where the JAX package calls `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
