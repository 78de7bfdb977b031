"""Grading a staged split: the window drives the program's
`evaluate.evaluate(cfg, model, batches=..., table=...)` in whole passes
over the split, its features staged on the device in one table and its
batches feature-free (video_row, words, masks, moments), as the program's
staging yields them.

End to end: `eval_qps`, the valid queries of the passes completed in the
window over the seconds those passes took.

What decides `correct` (after the window, the program freed): the first
pass of the window and one more drawn from the seed (a reservoir over the
window's passes) keep the model outputs of every step, caught by a forward
hook (references only: no work on the device). The reference runs the
whole split in fp32 and grades it; the numbers:

  out_rms     root mean square of program − reference over the reference's,
              the worst of the match logits, IoU logits and segments
  post_gap    widest gap in percentage points between the pass's metrics
              and the reference's grading of the program's outputs: the
              scoring, top-k, NMS and recall stage held by itself

Shown beside them, not compared, as neither tells the fp8 control from
the program on every seed: `out_gap`, the widest |program − reference|
over the reference's root mean square (a widest gap swings from seed to
seed), and `recall_gap`, the widest gap in percentage points between the
pass's metrics and the reference's own grading of its own outputs
(near-ties of random weights flip either way in any precision).
"""

from __future__ import annotations

import random
import time

import torch

from port_bench import gen, harness
from port_bench.reference import model as ref
from port_bench.reference import post
from port_bench.tracing import Ranges, traced

OUTPUTS = ("match_logits", "iou_logits", "segments")
PARTS = ("query_encoder", "backbone", "heads")


class PassCapture:
    """The model's outputs, step by step, of the window's first pass and of
    one more drawn from the seed; the metrics of every pass."""

    def __init__(self, model, seed: int):
        self.rng = random.Random(seed)
        self.current, self.kept, self.metrics = [], [], []
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        self.current.append({k: out[k] for k in OUTPUTS})

    def end_pass(self, metrics: dict) -> None:
        i = len(self.metrics)
        self.metrics.append(metrics)
        steps, self.current = self.current, []
        if i == 0:
            self.kept.append((i, steps))
        elif self.rng.random() < 1.0 / i:
            self.kept[1:] = [(i, steps)]

    def remove(self) -> None:
        self.handle.remove()


def run(ctx: harness.Ctx) -> dict:
    from drn_tpu_torch import evaluate as program

    cfg = harness.program_config(ctx.conf, ctx.traffic)
    dev = ctx.device
    ctx.phase("import")
    if dev.type == "cuda":
        harness.build_kernels()
        ctx.phase("compile")
    model, shapes = harness.build_model(ctx, cfg)
    ctx.phase("model")
    model.eval()
    split = gen.queries(ctx.traffic, ctx.dims, ctx.seed)
    n_valid = int(split["valid"].sum())
    table = gen.table(ctx.traffic, ctx.dims, ctx.seed, dev)
    batches = gen.Batches(gen.eval_batches(split, ctx.traffic["batch"]))
    ctx.phase("data")

    def one_pass():
        return program.evaluate(cfg, model, batches=batches, table=table,
                                device=dev)

    one_pass()  # warm-up: every shape of the window, the packed weights
    ctx.mark_setup()

    cap = PassCapture(model, ctx.seed)
    t0 = time.perf_counter()
    while True:
        cap.end_pass(one_pass())
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    cap.remove()
    passes = len(cap.metrics)
    result = {"e2e": {"eval_qps": passes * n_valid / elapsed},
              "attempted": passes * n_valid, "failed": 0}
    if dev.type == "cuda":
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    if ctx.trace:
        ranges = Ranges(model, PARTS).install()

        def window():
            k = ctx.traffic["trace_passes"]
            for _ in range(k):
                one_pass()
            return k * len(batches), float(k * n_valid)

        tr = traced(window, harness.launch_counts)
        ranges.remove()
        result["window"] = harness.Window(tr, ctx, 1, ctx.traffic["batch"])

    kept = [(i, {k: torch.cat([s[k] for s in steps])[:n_valid]
                 for k in OUTPUTS}) for i, steps in cap.kept]
    metrics = [cap.metrics[i] for i, _ in kept]
    del cap, model, batches, one_pass
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["numbers"], result["info"] = check(ctx, shapes, split, table,
                                              kept, metrics)
    return result


def reference_outputs(ctx: harness.Ctx, shapes, split, table, q=ref.identity,
                      rows: int = 256):
    """The reference's outputs over the whole split and its grading counts,
    in blocks of `rows`."""
    dims, dev = ctx.dims, table.device
    ev = ctx.conf["eval"]
    with ref.fp32_mode(), torch.no_grad():
        p = gen.weights(shapes, ctx.seed, dev)
        outs, counts = {k: [] for k in OUTPUTS}, {}
        n = len(split["valid"])
        for i in range(0, n, rows):
            sl = slice(i, min(i + rows, n))
            b = {k: torch.as_tensor(v[sl]).to(dev) for k, v in split.items()}
            o = ref.forward(p, dims, table[b["video_row"].long()],
                            b["word_ids"], b["query_mask"], q)
            counts = post.add(counts, post.grade(
                ev, o["match_logits"], o["iou_logits"], o["segments"],
                b["gt_grid"], b["valid"]))
            for k in OUTPUTS:
                outs[k].append(o[k])
    return {k: torch.cat(v) for k, v in outs.items()}, counts


def grade_outputs(ctx, split, outs, rows: int = 1024):
    dev = outs["segments"].device
    counts = {}
    n = len(split["valid"])
    with torch.no_grad():
        for i in range(0, n, rows):
            sl = slice(i, min(i + rows, n))
            counts = post.add(counts, post.grade(
                ctx.conf["eval"], outs["match_logits"][sl],
                outs["iou_logits"][sl], outs["segments"][sl],
                torch.as_tensor(split["gt_grid"][sl]).to(dev),
                torch.as_tensor(split["valid"][sl]).to(dev)))
    return counts


def readings(ctx, split, ref_outs, ref_counts, kept, metrics):
    """The compared numbers of the program's kept passes (or of a
    control's outputs in their place), and what is shown beside them."""
    n_valid = int(split["valid"].sum())
    ref_pct = post.percent(ref_counts, n_valid)
    numbers = {"out_rms": 0.0, "post_gap": 0.0}
    info = {"recall_gap": 0.0, "out_gap": 0.0}
    for (_, outs), m in zip(kept, metrics):
        whole = all(outs[k].shape == ref_outs[k].shape for k in OUTPUTS)
        for k in OUTPUTS:
            gap = harness.relative_gap(outs[k], ref_outs[k]) if whole \
                else float("inf")
            rms = harness.relative_rms(outs[k], ref_outs[k]) if whole \
                else float("inf")
            numbers["out_rms"] = max(numbers["out_rms"], rms)
            info["out_gap"] = max(info["out_gap"], gap)
            info[f"gap.{k}"] = max(info.get(f"gap.{k}", 0.0), gap)
            info[f"rms.{k}"] = max(info.get(f"rms.{k}", 0.0), rms)
        info["recall_gap"] = max(info["recall_gap"], post.gap(m, ref_pct)[0])
        mine = post.percent(grade_outputs(ctx, split, outs), n_valid) \
            if whole else {}
        numbers["post_gap"] = max(numbers["post_gap"], post.gap(m, mine)[0])
    return numbers, info


def check(ctx, shapes, split, table, kept, metrics) -> dict:
    ref_outs, ref_counts = reference_outputs(ctx, shapes, split, table)
    return readings(ctx, split, ref_outs, ref_counts, kept, metrics)


def control(ctx, shapes, split, table, rounding) -> dict:
    """The control's numbers: the reference in `rounding`'s precision in
    the program's place, graded by its own post-processing."""
    ref_outs, ref_counts = reference_outputs(ctx, shapes, split, table)
    low, low_counts = reference_outputs(ctx, shapes, split, table, rounding)
    n_valid = int(split["valid"].sum())
    return readings(ctx, split, ref_outs, ref_counts, [(0, low)],
                    [post.percent(low_counts, n_valid)])
