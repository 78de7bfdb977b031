"""The readers of the program's own ranges (`drn.*`, spans.py and the
metrics on it), on hand-made trace events: kernels to ranges by their
launch, on any thread inside the backward; idle gaps to the innermost
range open on the main thread; and None, never 0, from a trace of a
program that opens no such range."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness, spans, spec
from port_bench.tracing import Trace

MAIN, AUTOGRAD, DEV = 1, 2, 7
TRAIN_METRICS = ("gather_ms.train", "loss_ms.train", "backward_ms.train",
                 "idle_program_ms.train")
EVAL_METRICS = ("post_span_ms.eval", "gather_ms.eval",
                "idle_program_ms.eval")


def ev(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def launch(corr, ts, tid=MAIN):
    return ev("cuda_runtime", "cudaLaunchKernel", tid, ts, 1,
              correlation=corr)


def kernel(corr, ts, dur):
    return ev("kernel", f"k{corr}", DEV, ts, dur, correlation=corr)


def user(name, ts, dur, tid=MAIN):
    return ev("user_annotation", name, tid, ts, dur)


TRAIN = [
    user("drn.train.step", 0, 200),
    user("drn.train.gather", 5, 10),
    user("drn.train.forward", 20, 30),
    user("pb.forward", 21, 28),
    user("drn.train.loss", 55, 10),
    user("drn.train.backward", 70, 100),
    user("drn.train.optimizer", 175, 20),
    user("pb.optimizer", 176, 18),
    launch(1, 6), kernel(1, 8, 10),          # the gather
    launch(2, 25), kernel(2, 26, 20),        # the forward
    launch(3, 57), kernel(3, 60, 4),         # the loss
    launch(4, 80, AUTOGRAD), kernel(4, 82, 50),   # backward, autograd's
    launch(5, 140, AUTOGRAD), kernel(5, 140, 30),
    launch(6, 176), kernel(6, 180, 10),      # the optimizer
]

EVAL = [
    user("drn.eval.pass", 0, 100),
    user("drn.eval.step", 10, 50),
    user("drn.eval.gather", 11, 4),
    user("drn.eval.forward", 16, 24),
    user("drn.eval.post", 42, 10),
    user("drn.eval.fetch", 80, 20),
    launch(1, 12), kernel(1, 12, 8),
    launch(2, 17), kernel(2, 20, 20),
    launch(3, 43), kernel(3, 44, 6),
    launch(4, 85), ev("gpu_memcpy", "Memcpy DtoH", DEV, 95, 5,
                      correlation=4),
]


def window(events, steps=1):
    t = Trace(events, window_s=1e-3, steps=steps, units=1.0, launches={})
    conf = {"model": {}, "data": {"num_clips": 1, "max_query_len": 1}}
    ctx = harness.Ctx(cell={}, conf=conf, traffic={}, limits={}, seed=0, seconds=1, trace=True,
                      t_start=0.0, device=torch.device("cpu"))
    return harness.Window((t, t), ctx, stage=1, batch=1)


def read(name, w):
    return spec.metric(name).read(w)


def test_a_backward_kernel_on_autograd_thread_counts_there():
    w = window(TRAIN)
    assert read("backward_ms.train", w) == pytest.approx(0.080)
    assert read("gather_ms.train", w) == pytest.approx(0.010)
    assert read("loss_ms.train", w) == pytest.approx(0.004)
    # the three together are what lies outside the forward and optimizer
    outside = w.per_step_ms(w.trace.outside(["pb.forward", "pb.optimizer"]))
    got = sum(read(m, w) for m in ("gather_ms.train", "loss_ms.train",
                                   "backward_ms.train"))
    assert got == pytest.approx(outside)
    # the thread is dropped for the backward only
    assert [k["args"]["correlation"] for k in
            spans.launched_in(w.trace, "drn.train.step")] == [1, 2, 3, 6]


def test_a_gap_half_inside_the_fetch_counts_half():
    events = [user("drn.eval.pass", 0, 100), user("drn.eval.step", 0, 70),
              launch(1, 1), kernel(1, 0, 70),
              user("drn.eval.fetch", 70, 30),
              launch(2, 120), kernel(2, 130, 10)]
    w = window(events)
    # one gap, 70-130: its first half under the fetch, its second under no
    # range of the program (the caller's, after the pass returned)
    assert spans.idle_by_span(w.trace) == pytest.approx(
        {None: 30.0, "drn.eval.fetch": 30.0})
    assert read("idle_program_ms.eval", w) == pytest.approx(0.030)


def test_idle_under_the_innermost_range():
    w = window(EVAL)
    # busy 12-40, 44-50, 95-100 in the window 0-100 (the pass)
    idle = spans.idle_by_span(w.trace)
    assert idle == pytest.approx({
        None: 0.0, "drn.eval.pass": 10 + 20, "drn.eval.step": 1 + 2 + 8,
        "drn.eval.gather": 1.0, "drn.eval.post": 2 + 2,
        "drn.eval.fetch": 15.0})
    assert read("idle_program_ms.eval", w) == pytest.approx(0.061)


def test_eval_readers():
    w = window(EVAL, steps=1)
    assert read("post_span_ms.eval", w) == pytest.approx(0.006)
    assert read("gather_ms.eval", w) == pytest.approx(0.008)


def test_a_gap_outside_every_range_is_the_callers():
    events = EVAL + [user("drn.eval.pass", 200, 50),
                     launch(9, 210), kernel(9, 300, 10)]
    idle = spans.idle_by_span(window(events).trace)
    assert idle[None] == pytest.approx(300 - 250 + 200 - 100)


@pytest.mark.parametrize("name", TRAIN_METRICS + EVAL_METRICS)
def test_a_trace_without_program_ranges_reads_none(name):
    events = [e for e in TRAIN + EVAL if not e["name"].startswith("drn.")]
    assert read(name, window(events)) is None
