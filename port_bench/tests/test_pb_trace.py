"""The reading of a profiler trace: launches matched to kernels by
correlation id, kernels to the benchmark's ranges on the launching
thread, backward nodes to the forward ranges by sequence number, the
post-forward span up to the next copy, busy time and the breakdown."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.tracing import Ranges, Trace, union_us

MAIN, BWD = 1, 2


def ev(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def kernel(corr, ts, dur, name="k"):
    return ev("kernel", name, 7, ts, dur, correlation=corr)


EVENTS = [
    ev("user_annotation", "pb.forward", MAIN, 100, 100),
    ev("user_annotation", "pb.backbone", MAIN, 110, 40),
    ev("cpu_op", "FusedStemFn", MAIN, 120, 10, **{"Sequence number": 5}),
    ev("cuda_runtime", "cudaLaunchKernel", MAIN, 125, 1, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", MAIN, 160, 1, correlation=2),
    ev("cuda_runtime", "cudaLaunchKernel", MAIN, 210, 1, correlation=3),
    ev("cuda_runtime", "cudaMemcpyAsync", MAIN, 190, 2, correlation=8),
    ev("cuda_runtime", "cudaMemcpyAsync", MAIN, 205, 2, correlation=9),
    ev("cuda_runtime", "cudaMemcpyAsync", MAIN, 220, 5, correlation=4),
    ev("cuda_runtime", "cudaLaunchKernel", MAIN, 230, 1, correlation=5),
    ev("cpu_op", "autograd::engine::evaluate_function: FusedStemFnBackward",
       BWD, 300, 50, **{"Sequence number": 5}),
    ev("cuda_runtime", "cudaLaunchKernel", BWD, 310, 1, correlation=6),
    ev("cpu_op", "aten::copy_", MAIN, 360, 40),
    kernel(1, 130, 20, "stem"), kernel(2, 170, 10), kernel(3, 215, 5, "sort"),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 7, 226, 4,
       correlation=4),
    ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 7, 211, 1,
       correlation=9),
    kernel(5, 240, 10), kernel(6, 320, 30, "stem_bwd"),
    kernel(99, 400, 10, "unmatched"),
]


@pytest.fixture
def trace():
    return Trace(EVENTS, window_s=400e-6, steps=2, units=10.0,
                 launches={"fused_stem": 1})


def names(ks):
    return sorted(k["args"]["correlation"] for k in ks)


def test_kernels_by_range_and_thread(trace):
    assert names(trace.in_range("pb.backbone")) == [1]
    assert names(trace.in_range("pb.forward")) == [1, 2]
    assert names(trace.after_forward()) == [3]
    assert names(trace.backward_of("pb.backbone")) == [6]
    assert names(trace.outside(["pb.forward"])) == [3, 5, 6]
    assert names(trace.outside([])) == [1, 2, 3, 5, 6]  # 99 has no launch


def test_busy_time_and_breakdown(trace):
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.busy_s == pytest.approx((20 + 10 + 5 + 1 + 4 + 10 + 30 + 10)
                                         * 1e-6)
    b = trace.breakdown()
    assert b["device_ops"][0] == ["stem_bwd", pytest.approx(30e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(50e-6)  # 350 → 400


def test_window_readings(trace):
    ctx = harness.Ctx(cell={}, conf={"model": {"num_levels": 1,
                                               "hidden_dim": 8,
                                               "feature_dim": 8},
                                     "data": {"num_clips": 4,
                                              "max_query_len": 2}},
                      traffic={}, limits={}, seed=0, seconds=1, trace=True,
                      t_start=0.0, device=torch.device("cpu"))
    w = harness.Window((trace, trace), ctx, stage=1, batch=2)
    assert w.per_step_ms(trace.in_range("pb.backbone")) == pytest.approx(0.01)
    bound = w.bound_s(w.work("backbone"))
    assert w.roofline(w.work("backbone"), trace.in_range("pb.backbone")) \
        == pytest.approx(100 * bound / 1e-5)


def test_ranges_open_and_close_around_forwards_and_the_step():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2))

    class Opt:
        def step(self):
            return "stepped"

    opt = Opt()
    r = Ranges(model, ["0"], opt).install()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(torch.ones(1, 2))
        assert opt.step() == "stepped"
    r.remove()
    got = {e.name for e in prof.events()}
    assert {"pb.forward", "pb.0", "pb.optimizer"} <= got
    assert "step" not in opt.__dict__ and not model._forward_hooks
