"""The program's own ranges (drn_tpu_torch/utils/profiling.py::span) on the
CPU at synthetic_tiny: with no profiler recording, one shared no-op that
leaves the exported graph as it was; under a profiler, every `drn.eval.*`
range of an `evaluate()` pass and every `drn.train.*` range of a train
step and of the trainer's loop, nested as the program nests them, with
each model part's ATen ops inside its `drn.model.<part>` range on the
same clock; and `span_table`, which `python -m drn_tpu_torch.profile`
reads a trace with, on hand-made events."""

import contextlib
import dataclasses
import json

import pytest
import torch

from drn_tpu_torch import evaluate as ev
from drn_tpu_torch import train as tr
from drn_tpu_torch.config import get_config
from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
from drn_tpu_torch.models import drn as drn_module
from drn_tpu_torch.utils.profiling import span, span_table

from torch_threads import one_torch_thread  # noqa: F401

EVAL = ("pass", "batch", "step", "gather", "forward", "post", "fetch")
TRAIN = ("gather", "forward", "loss", "backward", "optimizer")
# An op that each part's forward runs and no other part's does.
PART_OPS = {"query_encoder": "aten::lstm", "backbone": "FusedStemFn",
            "fusion": "FusedFusionBlockFn", "fpn": "aten::repeat_interleave",
            "heads": "aten::exp", "iou_head": "aten::floor"}


def tiny(examples: int = 24):
    cfg = get_config("synthetic_tiny")
    return cfg.replace(data=dataclasses.replace(
        cfg.data, synthetic_examples=examples))


def profiled(fn, path):
    """The chrome-trace events of a CPU profiler session around fn()."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def named(events, name):
    return [e for e in events if e.get("ph") == "X" and e["name"] == name]


def inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def within(events, name, outer):
    return [e for e in named(events, name) if inside(e, outer)]


@pytest.fixture(scope="module")
def eval_trace(tmp_path_factory):
    """One `evaluate()` pass over 3 batches of 8, profiled."""
    cfg = tiny()
    model = ev.build_model(cfg, device="cpu")
    ev.evaluate(cfg, model, device="cpu")  # warm
    return profiled(lambda: ev.evaluate(cfg, model, device="cpu"),
                    tmp_path_factory.mktemp("spans") / "eval.json")


def test_without_a_profiler_a_span_is_the_shared_no_op():
    a, b = span("eval.step"), span("train.backward")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass


def test_the_exported_graph_holds_no_range(monkeypatch):
    cfg = tiny()
    model = ev.build_model(cfg, device="cpu")
    b, t = 2, cfg.data.num_clips
    args = (torch.zeros(b, t, cfg.model.feature_dim),
            torch.zeros(b, cfg.data.max_query_len, dtype=torch.int32),
            torch.ones(b, cfg.data.max_query_len, dtype=torch.bool))

    def ops():
        with torch.no_grad():
            ep = torch.export.export(model, args)
        return [str(n.target) for n in ep.graph.nodes
                if n.op == "call_function"]

    with_spans = ops()
    assert not [o for o in with_spans if "profiler" in o]
    monkeypatch.setattr(drn_module, "span",
                        lambda name: contextlib.nullcontext())
    assert ops() == with_spans  # the graph of a forward with no ranges


def test_an_evaluate_pass_opens_every_eval_range(eval_trace):
    (pas,) = named(eval_trace, "drn.eval.pass")
    for n in [f"drn.eval.{n}" for n in EVAL] + ["drn.to_device"]:
        assert named(eval_trace, n), n
    for n in ("drn.eval.batch", "drn.to_device", "drn.eval.step",
              "drn.eval.fetch"):
        assert len(named(eval_trace, n)) == len(within(eval_trace, n, pas))
    steps = named(eval_trace, "drn.eval.step")
    assert len(steps) == 3 and len(named(eval_trace, "drn.to_device")) == 3
    assert len(named(eval_trace, "drn.eval.batch")) == 4  # and the end
    for step in steps:
        for n in ("gather", "forward", "post"):
            assert len(within(eval_trace, f"drn.eval.{n}", step)) == 1
    (fetch,) = named(eval_trace, "drn.eval.fetch")
    assert fetch["ts"] > max(s["ts"] + s["dur"] for s in steps)


@pytest.mark.parametrize("part", sorted(PART_OPS))
def test_each_part_and_its_ops_inside_its_range(eval_trace, part):
    forwards = named(eval_trace, "drn.eval.forward")
    ranges = named(eval_trace, f"drn.model.{part}")
    assert len(ranges) == len(forwards) == 3
    for f in forwards:
        assert len(within(eval_trace, f"drn.model.{part}", f)) == 1
    ops = [o for f in forwards for o in within(eval_trace, PART_OPS[part], f)]
    assert ops and all(any(inside(o, r) for r in ranges) for o in ops)


def test_a_train_step_opens_every_train_range(tmp_path):
    cfg = tiny(8)
    model = ev.build_model(cfg, device="cpu").train()
    step = tr.make_train_step(cfg, model, tr.make_optimizer(cfg, 1, model))
    batch = next(BatchIterator(make_dataset(cfg.data, cfg.model), 8,
                               shuffle=False).epoch(0))
    step(ev.to_device(batch, "cpu"))
    events = profiled(lambda: step(ev.to_device(batch, "cpu")),
                      tmp_path / "train.json")
    (whole,) = named(events, "drn.train.step")
    for n in TRAIN:
        assert len(named(events, f"drn.train.{n}")) == 1, n
        assert len(within(events, f"drn.train.{n}", whole)) == 1, n
    (fwd,) = named(events, "drn.train.forward")
    assert len(within(events, "drn.model.backbone", fwd)) == 1
    (bwd,) = named(events, "drn.train.backward")
    assert [e for e in events if e.get("cat") == "cpu_op"
            and e["name"].startswith("autograd::engine::evaluate_function")
            and bwd["ts"] <= e["ts"] <= bwd["ts"] + bwd["dur"]]
    (to_dev,) = named(events, "drn.to_device")
    assert to_dev["ts"] + to_dev["dur"] <= whole["ts"]


def test_the_trainer_loop_fetches_each_batch_in_a_range(tmp_path):
    cfg = tiny(16)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, num_epochs=1, eval_every_epochs=0,
        checkpoint_dir=str(tmp_path / "ckpt")))
    events = profiled(lambda: tr.train(cfg, device="cpu", max_steps=2),
                      tmp_path / "loop.json")
    assert len(named(events, "drn.train.step")) == 2
    assert len(named(events, "drn.train.batch")) == 2


def k_ev(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def test_span_table_reads_ranges_kernels_and_gaps():
    main, autograd = 1, 2
    events = [
        k_ev("user_annotation", "drn.train.step", main, 0, 100),
        k_ev("user_annotation", "drn.train.loss", main, 10, 10),
        k_ev("user_annotation", "drn.train.backward", main, 30, 60),
        k_ev("cuda_runtime", "cudaLaunchKernel", main, 12, 1, correlation=1),
        k_ev("cuda_runtime", "cudaLaunchKernel", autograd, 40, 1,
             correlation=2),
        k_ev("cuda_runtime", "cudaLaunchKernel", main, 95, 1, correlation=3),
        k_ev("kernel", "loss_k", 7, 14, 6, correlation=1),
        k_ev("kernel", "bwd_k", 7, 42, 20, correlation=2),
        k_ev("kernel", "tail_k", 7, 96, 4, correlation=3),
    ]
    t = span_table(events, steps=2)
    s = t["spans"]
    assert s["drn.train.loss"]["device_ms"] == pytest.approx(0.003)
    # launched on autograd's thread inside the backward: the backward's
    assert s["drn.train.backward"]["device_ms"] == pytest.approx(0.010)
    assert s["drn.train.step"]["device_ms"] == pytest.approx(0.015)
    assert s["drn.train.step"]["self_ms"] == pytest.approx(0.002)
    assert t["window_ms"] == pytest.approx(0.05)
    assert t["busy_ms"] == pytest.approx(0.015)
    # idle: 0-10, 20-30 under the step; 10-14 under the loss; 30-42 and
    # 62-90 under the backward; 90-96 under the step again
    assert s["drn.train.step"]["idle_ms"] == pytest.approx(0.013)
    assert s["drn.train.loss"]["idle_ms"] == pytest.approx(0.002)
    assert s["drn.train.backward"]["idle_ms"] == pytest.approx(0.020)
    assert t["outside"] == {"self_ms": 0.0, "idle_ms": 0.0}
    with pytest.raises(RuntimeError, match="no span"):
        span_table(events[3:], steps=1)
