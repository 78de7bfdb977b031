"""Grading a staged split with 2D-TAN (configs/tacos_2dtan_c3d.json): the
window drives the program's `evaluate.evaluate(cfg, model, batches=...,
table=...)` in whole passes over the split, as entries/eval_split.py does
for DRN; the model is the program's `evaluate.build_model` of the
configuration.

Weights: `gen.weights` (every weight z / sqrt(fan_in)), then each map
conv's weight times its gain g_l (the configuration's
`assumed.map_conv_gains`). Without them each of the 8 layers of ReLU ·
(1 / count) would shrink the map's spread across the valid moments ~5
to 30 times, and the logits would be the prediction's bias alone; the
gains keep that spread at each layer's input's (tan_gains.py). Both
sides get the same dict.

End to end: `eval_qps`, the valid queries of the passes completed in the
window over the seconds those passes took.

What decides `correct` (after the window, the program freed): the first
pass of the window and one more drawn from the seed keep the model's
outputs of every step. The reference (reference/tan.py) runs the split in
fp32, in blocks of queries, and grades it (reference/post.py):

  out_rms   root mean square of program − reference over the reference's,
            of the valid moments' match logits, each query's mean taken
            out of both: the prediction's bias, one scalar drawn from the
            seed, is added alike to every logit of every query, and would
            otherwise set the denominator (0.1·|z| against a spread of
            ~0.05 across a query's moments)
  post_gap  widest gap in percentage points between the pass's metrics
            and the reference's grading of the program's outputs

Shown beside them, not compared: `out_gap` (the widest |program −
reference| over the reference's root mean square, of the centred
logits), `rms.match_logits` (out_rms of the logits as they are),
`recall_gap` (the pass's metrics against the reference's grading of its
own outputs) and `gap.segments` (the moments are constants: 0).

The cell's per-layer window also records `map_conv_cells`, the map-conv
output cells computed a step (the program's counter `map_epilogue.cells`,
drn_tpu_torch/ops/cuda/map_epilogue.py, over every step the traced
sessions ran), for `map_dead_share.eval`.
A program without 2D-TAN fails at its configuration, before any work.
"""

from __future__ import annotations

import time

import torch

from port_bench import gen, harness
from port_bench.entries import eval_split
from port_bench.reference import model as ref
from port_bench.reference import post
from port_bench.reference import tan as ref_tan
from port_bench.tracing import Ranges, traced

OUTPUTS = ("match_logits", "segments")
PARTS = ("query_encoder",)
FAULTS = ("no_count_weights", "conv_zeroed")
ZEROED_LAYER = 3
# Profiler sessions `traced` may take of each kind. A session of this cell
# holds ~80,000 kernels (the NMS sweep's ~7,650 a step). On an H100 the
# profiler lost 64 to 5,306 of their records in 4 of 10 later sessions,
# and the first session after the timed window holds one fill more than
# the rest: with `traced`'s default of 4, no two sessions agreed in some
# runs, and the run failed.
TRACE_SESSIONS = 16


class PassCapture(eval_split.PassCapture):
    """eval_split's capture (the window's first pass and one more drawn
    from the seed), of 2D-TAN's outputs."""

    def _hook(self, module, args, out):
        self.current.append({k: out[k] for k in OUTPUTS})


def weights(ctx: harness.Ctx, shapes, device):
    """The seed's parameters with the map convs' gains."""
    w = gen.weights(shapes, ctx.seed, device)
    for l, g in enumerate(ctx.conf["assumed"]["map_conv_gains"]):
        w[f"map_conv.convs.{l}.weight"] *= g
    return w


def build_model(ctx: harness.Ctx, cfg, fault: str = None):
    """The program's 2D-TAN on the device with the seed's weights;
    → (model, the parameters' shapes). `fault` plants one of FAULTS in
    this model alone: the count weights left out (w_l = 1 everywhere), or
    one map conv's weights zeroed."""
    from drn_tpu_torch import evaluate as program

    model = program.build_model(cfg, device=ctx.device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = weights(ctx, shapes, ctx.device)
    if fault == "conv_zeroed":
        w[f"map_conv.convs.{ZEROED_LAYER}.weight"].zero_()
    model.load_state_dict(w)
    del w
    if fault == "no_count_weights":
        for l in range(len(model.map_conv.convs)):
            model.map_conv.count_weight(l).fill_(1.0)
    elif fault not in (None, "conv_zeroed"):
        raise KeyError(f"no fault {fault!r}; there are {FAULTS}")
    return model, shapes


def run(ctx: harness.Ctx, fault: str = None) -> dict:
    cfg = harness.program_config(ctx.conf, ctx.traffic)
    from drn_tpu_torch import evaluate as program
    from drn_tpu_torch.ops.cuda.map_epilogue import map_epilogue

    dev = ctx.device
    ctx.phase("import")
    if dev.type == "cuda":
        harness.build_kernels()
        ctx.phase("compile")
    model, shapes = build_model(ctx, cfg, fault)
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

    one_pass()  # warm-up: every shape of the window
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
        ran = [0]

        def window():
            k = ctx.traffic["trace_passes"]
            for _ in range(k):
                one_pass()
            ran[0] += k * len(batches)
            return k * len(batches), float(k * n_valid)

        cells = map_epilogue.cells
        tr = traced(window, harness.launch_counts, most=TRACE_SESSIONS)
        cells = map_epilogue.cells - cells
        ranges.remove()
        result["window"] = harness.Window(tr, ctx, 1, ctx.traffic["batch"])
        result["window"].map_conv_cells = cells / ran[0]

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
                      rows: int = 16):
    """The reference's outputs over the whole split, in blocks of `rows`
    queries, and its grading counts."""
    dims, dev = ctx.dims, table.device
    with ref.fp32_mode(), torch.no_grad():
        p = weights(ctx, shapes, dev)
        outs = {k: [] for k in OUTPUTS}
        n = len(split["valid"])
        for i in range(0, n, rows):
            sl = slice(i, min(i + rows, n))
            b = {k: torch.as_tensor(v[sl]).to(dev) for k, v in split.items()}
            o = ref_tan.forward(p, dims, table[b["video_row"].long()],
                                b["word_ids"], b["query_mask"], q)
            for k in OUTPUTS:
                outs[k].append(o[k])
        del p
    outs = {k: torch.cat(v) for k, v in outs.items()}
    return outs, grade_outputs(ctx, split, outs)


def grade_outputs(ctx, split, outs, rows: int = 64):
    dev = outs["segments"].device
    counts = {}
    n = len(split["valid"])
    with torch.no_grad():
        for i in range(0, n, rows):
            sl = slice(i, min(i + rows, n))
            counts = post.add(counts, post.grade(
                ctx.conf["eval"], outs["match_logits"][sl], None,
                outs["segments"][sl],
                torch.as_tensor(split["gt_grid"][sl]).to(dev),
                torch.as_tensor(split["valid"][sl]).to(dev)))
    return counts


def centred(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=1, keepdim=True)


def readings(ctx, split, ref_outs, ref_counts, kept, metrics):
    """The compared numbers of the program's kept passes (or of a
    control's outputs in their place), and what is shown beside them."""
    n_valid = int(split["valid"].sum())
    ref_pct = post.percent(ref_counts, n_valid)
    numbers = {"out_rms": 0.0, "post_gap": 0.0}
    info = {"recall_gap": 0.0, "out_gap": 0.0, "rms.match_logits": 0.0,
            "gap.segments": 0.0}
    r = ref_outs["match_logits"]
    for (_, outs), m in zip(kept, metrics):
        whole = all(outs[k].shape == ref_outs[k].shape for k in OUTPUTS)
        inf = float("inf")
        p = outs["match_logits"]
        numbers["out_rms"] = max(numbers["out_rms"], harness.relative_rms(
            centred(p), centred(r)) if whole else inf)
        info["out_gap"] = max(info["out_gap"], harness.relative_gap(
            centred(p), centred(r)) if whole else inf)
        info["rms.match_logits"] = max(info["rms.match_logits"],
                                       harness.relative_rms(p, r)
                                       if whole else inf)
        info["gap.segments"] = max(info["gap.segments"], float(
            (outs["segments"] - ref_outs["segments"]).abs().max())
            if whole else inf)
        info["recall_gap"] = max(info["recall_gap"], post.gap(m, ref_pct)[0])
        mine = post.percent(grade_outputs(ctx, split, outs), n_valid) \
            if whole else {}
        numbers["post_gap"] = max(numbers["post_gap"], post.gap(m, mine)[0])
    return numbers, info


def check(ctx, shapes, split, table, kept, metrics):
    ref_outs, ref_counts = reference_outputs(ctx, shapes, split, table)
    return readings(ctx, split, ref_outs, ref_counts, kept, metrics)


def control(ctx, shapes, split, table, rounding):
    """The control's numbers: the reference in `rounding`'s precision in
    the program's place, graded by its own post-processing."""
    ref_outs, ref_counts = reference_outputs(ctx, shapes, split, table)
    low, low_counts = reference_outputs(ctx, shapes, split, table, rounding)
    n_valid = int(split["valid"].sum())
    return readings(ctx, split, ref_outs, ref_counts, [(0, low)],
                    [post.percent(low_counts, n_valid)])
