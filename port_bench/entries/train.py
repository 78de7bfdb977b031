"""Stage-1 training from a staged table: the window drives the program's
`train.make_train_step` step on batches moved by `evaluate.to_device` and
gathered from the split's table on the device, as `train.train(
device_features=True)` feeds it: shuffled epochs from the seed, no
checkpoints, no evaluation, no logging.

End to end: `train_eps`, the valid examples stepped in the window over the
window's seconds.

What decides `correct`: set-up builds one step (model, optimizer) and
drives it through its first `check_steps` steps with the window's own call
and feed, on rows that all differ; the same object then runs the window.
After the window, with the program freed, the reference takes the same
weights and batches through the same steps in fp32. The numbers:

  loss_gap    widest |program − reference| / |reference| of a step's loss
  grad_gap    the worst leaf's gap of the first step's gradient norms, as
              the optimizer got it (its first moment after one step over
              1 − β1), over max(the leaf's norm, the median leaf's)
  change_gap  the same of the parameters' change over the checked steps,
              leaves whose reference gradient is under a thousandth of the
              median leaf's left out (they move by round-off alone)
"""

from __future__ import annotations

import time

import torch

from port_bench import gen, harness
from port_bench.reference import model as ref
from port_bench.reference import train as ref_train
from port_bench.tracing import Ranges, traced

PARTS = ("backbone",)
B1 = 0.9


def run(ctx: harness.Ctx) -> dict:
    from drn_tpu_torch import evaluate as ev
    from drn_tpu_torch import train as program

    cfg = harness.program_config(ctx.conf, ctx.traffic)
    dev = ctx.device
    ctx.phase("import")
    if dev.type == "cuda":
        harness.build_kernels()
        ctx.phase("compile")
    model, shapes = harness.build_model(ctx, cfg)
    ctx.phase("model")
    model.train()
    split = gen.queries(ctx.traffic, ctx.dims, ctx.seed)
    table = gen.table(ctx.traffic, ctx.dims, ctx.seed, dev)
    b = ctx.traffic["batch"]
    steps_per_epoch = -(-len(split["valid"]) // b)
    optimizer = program.make_optimizer(cfg, steps_per_epoch, model)
    step = program.make_train_step(cfg, model, optimizer)
    feed = gen.train_batches(split, b, ctx.seed)
    ctx.phase("data")

    initial = {k: v.detach().clone() for k, v in optimizer.params.items()}
    checked, losses, grads = [], [], None
    for i in range(ctx.traffic["check_steps"]):
        batch = next(feed)
        checked.append(batch)
        losses.append(step(ev.to_device(batch, dev), table)["loss"])
        if i == 0:
            grads = {k: (m / (1 - B1)).norm() for k, m in optimizer.mu.items()}
    change = {k: (v.detach() - initial[k]).norm()
              for k, v in optimizer.params.items()}
    prog = {"losses": [float(x) for x in losses],
            "grad": {k: float(v) for k, v in grads.items()},
            "change": {k: float(v) for k, v in change.items()}}
    del initial, grads, change
    ctx.mark_setup()

    steps = examples = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        batch = next(feed)
        step(ev.to_device(batch, dev), table)
        steps += 1
        examples += int(batch["valid"].sum())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    result = {"e2e": {"train_eps": examples / elapsed},
              "attempted": steps, "failed": 0}
    if dev.type == "cuda":
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    if ctx.trace:
        ranges = Ranges(model, PARTS, optimizer).install()

        def window():
            n, k = 0, ctx.traffic["trace_steps"]
            for _ in range(k):
                batch = next(feed)
                step(ev.to_device(batch, dev), table)
                n += int(batch["valid"].sum())
            return k, float(n)

        tr = traced(window, harness.launch_counts)
        ranges.remove()
        result["window"] = harness.Window(tr, ctx, ctx.traffic["stage"], b)

    del model, optimizer, step, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_steps(ctx, shapes, checked, table, steps_per_epoch)
    result["numbers"], result["info"] = readings(prog, reference)
    return result


def reference_steps(ctx, shapes, batches, table, steps_per_epoch,
                    q=ref.identity) -> dict:
    dev = table.device
    with ref.fp32_mode():
        p0 = gen.weights(shapes, ctx.seed, dev)
        moved = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                 for b in batches]
        return ref_train.train_steps(
            p0, ctx.dims, ctx.conf["train"] | {"stage": ctx.traffic["stage"]},
            moved, lambda b: table[b["video_row"].long()], steps_per_epoch, q)


def readings(prog: dict, reference: dict):
    """(the compared numbers, what is shown beside them: the worst leaves
    and the median leaf's gaps)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], reference["losses"]))
    if len(prog["losses"]) != len(reference["losses"]):
        loss_gap = float("inf")
    grad_gap, grad_leaf = harness.leaf_gap(prog["grad"], reference["grad"])
    g = reference["grad"]
    median = sorted(g.values())[len(g) // 2]
    moving = [k for k in g if g[k] >= 1e-3 * median]
    change_gap, change_leaf = harness.leaf_gap(
        prog["change"], reference["change"], moving)
    info = {"grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(g) - set(moving)),
            "grad_median_gap": harness.median_leaf_gap(prog["grad"], g),
            "change_median_gap": harness.median_leaf_gap(
                prog["change"], reference["change"], moving)}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}, info
