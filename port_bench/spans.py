"""Reading the program's own ranges (`drn.*`) in the full trace of a
traced window.

The program opens a range at each layer boundary of its eval and train
steps while a profiler session records (`drn.eval.step`, `drn.eval.post`,
`drn.train.backward`, `drn.model.<part>`, ...). A kernel belongs to such a
range when its launch lies inside it on the range's thread, as with the
benchmark's own ranges (`tracing.Trace.in_range`); inside
`drn.train.backward` a launch on any thread is the range's, since the
main thread waits in `.backward()` while autograd's thread launches the
kernels.

A program that opens no such range (an older one) reads None here, never
0: the metric is left out of the line.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from port_bench.tracing import Trace, merged

PREFIX = "drn."
ANY_THREAD = ("drn.train.backward",)
STEPS = ("drn.eval.step", "drn.train.step")


def launched_in(trace: Trace, name: str) -> Optional[List[dict]]:
    """The kernels launched inside range `name`; None when the trace has
    no such range."""
    ranges = trace.ranges.get(name)
    if not ranges:
        return None
    any_thread = name in ANY_THREAD
    out = []
    for k in trace.kernels:
        at = trace.launch(k)
        if at is not None and any((any_thread or tid == at[0])
                                  and s <= at[1] <= e
                                  for tid, s, e in ranges):
            out.append(k)
    return out


def span_ms(w, name: str) -> Optional[float]:
    """Device ms a step of the kernels launched inside range `name`."""
    kernels = launched_in(w.trace, name)
    return None if kernels is None else Trace.ms(kernels) / w.steps


def main_thread(trace: Trace) -> Optional[int]:
    """The thread that runs the steps: the one with the step ranges."""
    for name in STEPS:
        if trace.ranges.get(name):
            return trace.ranges[name][0][0]
    return None


def innermost(ranges: Iterable[Tuple[float, float, str]]
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


def idle_gaps(trace: Trace, start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The pieces of [start, end] in which no kernel, copy or set ran."""
    gaps, t = [], start
    for s, e in merged((d["ts"], d["ts"] + d["dur"]) for d in trace.device):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


def idle_by_span(trace: Trace) -> Optional[Dict[str, float]]:
    """Device-idle µs of the window under each innermost program range open
    on the main thread, and under None the rest (the caller's). The window
    runs from the first program range or device operation to the last.
    None when the trace has no program range."""
    tid = main_thread(trace)
    if tid is None:
        return None
    ranges = [(s, e, n) for n, v in trace.ranges.items()
              if n.startswith(PREFIX) for t, s, e in v if t == tid]
    edges = [(d["ts"], d["ts"] + d["dur"]) for d in trace.device]
    edges += [(s, e) for s, e, _ in ranges]
    start, end = min(s for s, _ in edges), max(e for _, e in edges)
    out: Dict[str, float] = defaultdict(float)
    pieces, j = innermost(ranges), 0
    for a, b in idle_gaps(trace, start, end):
        out[None] += b - a
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, n = pieces[k]
            covered = min(b, e) - max(a, s)
            out[n] += covered
            out[None] -= covered
            k += 1
    return dict(out)


def idle_program_ms(w) -> Optional[float]:
    """Device-idle ms a step under any program range on the main thread."""
    idle = idle_by_span(w.trace)
    if idle is None:
        return None
    return sum(us for n, us in idle.items() if n is not None) / 1e3 / w.steps
