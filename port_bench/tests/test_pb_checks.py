"""The comparison that decides `correct`, driven through each entry at
synthetic_tiny width on the CPU, where the program runs its kernels'
plain versions: the fp32 program agrees with the reference to rounding;
the reference computed in fp8 fails; and a run with the timed path broken
underneath (faults.py) reads `correct` false under the cells' limits."""

from __future__ import annotations

import pytest
import torch

from port_bench import faults, gen, harness, spec
from port_bench.entries import eval_split, train
from port_bench.reference import lowp
from port_bench.tests.conftest import make_ctx, tiny_conf

ENTRIES = {"eval_split": eval_split, "train": train}
CELLS = {c["name"]: spec.traffic(c["traffic"])["entry"]
         for c in spec.benchmark()["workloads"]}


def cell_limits(entry: str):
    """The limits of the benchmark's cells of `entry`, the tightest of
    each number."""
    out = {}
    for cell in spec.benchmark()["workloads"]:
        if spec.traffic(cell["traffic"])["entry"] == entry:
            for k, v in spec.limits(cell["name"]).items():
                out[k] = min(v, out.get(k, v))
    return out


def shapes_of(conf):
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.models import DRN

    cfg = get_config(conf["registry"])
    return {k: tuple(v.shape) for k, v in
            DRN(cfg.model, cfg.data.num_clips).state_dict().items()}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fp32_program_agrees_with_the_reference(cell, fp32_registry):
    """Each cell's path at synthetic_tiny width with fp32 compute."""
    entry = CELLS[cell]
    ctx = make_ctx(entry, tiny_conf(fp32_registry))
    numbers = ENTRIES[entry].run(ctx)["numbers"]
    assert numbers and all(v < 1e-3 for v in numbers.values()), numbers


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_fp8_control_fails(cell):
    """The reference in fp8 in the program's place fails the cell's
    limits."""
    entry = CELLS[cell]
    ctx = make_ctx(entry, tiny_conf())
    split = gen.queries(ctx.traffic, ctx.dims, ctx.seed)
    table = gen.table(ctx.traffic, ctx.dims, ctx.seed, "cpu")
    shapes = shapes_of(ctx.conf)
    if entry == "eval_split":
        numbers, _ = eval_split.control(ctx, shapes, split, table, lowp.fp8)
    else:
        feed = gen.train_batches(split, ctx.traffic["batch"], ctx.seed)
        batches = [next(feed) for _ in range(3)]
        ref = train.reference_steps(ctx, shapes, batches, table, 3)
        low = train.reference_steps(ctx, shapes, batches, table, 3, lowp.fp8)
        numbers, _ = train.readings(low, ref)
    verdict = harness.judge(numbers, spec.limits(cell))
    assert not verdict["correct"], numbers


@pytest.mark.parametrize("entry,fault", [(e, f) for e, fs in
                                         sorted(faults.FAULTS.items())
                                         for f in fs])
def test_a_broken_timed_path_reads_incorrect(entry, fault):
    ctx = make_ctx(entry, tiny_conf())
    with faults.plant(fault, entry):
        numbers = ENTRIES[entry].run(ctx)["numbers"]
    verdict = harness.judge(numbers, cell_limits(entry))
    assert not verdict["correct"], verdict["checks"]


def test_the_window_keeps_the_first_pass_and_one_drawn_from_the_seed():
    model = torch.nn.Identity()
    cap = eval_split.PassCapture(model, seed=3)
    for i in range(50):
        cap.current = [{"step": i}]
        cap.end_pass({"pass": i})
    cap.remove()
    kept = [i for i, _ in cap.kept]
    assert kept[0] == 0 and len(kept) == 2 and 0 < kept[1] < 50
