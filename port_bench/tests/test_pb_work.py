"""Each model part's count of operations (port_bench/work/<part>.py)
equals PyTorch's FlopCounterMode on the reference's part, forward, and
forward and backward where the part is trained."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import gen, spec
from port_bench.reference import model as ref
from port_bench.tests.conftest import tiny_conf

BATCH = 3


def inputs(dims, seed=5):
    from drn_tpu_torch.models import DRN

    from drn_tpu_torch.config import get_config
    cfg = get_config("synthetic_tiny")
    shapes = {k: tuple(v.shape) for k, v in
              DRN(cfg.model, dims["num_clips"]).state_dict().items()}
    p = gen.weights(shapes, seed, "cpu")
    split = gen.queries({"videos": 2, "queries": BATCH, "query_len": [2, 8],
                         "moment_frac": [0.1, 0.5],
                         "duration_s": [20.0, 40.0]}, dims, seed)
    feats = torch.randn(BATCH, dims["num_clips"], dims["feature_dim"])
    return p, {k: torch.as_tensor(v) for k, v in split.items()}, feats


def part_call(part, p, dims, b, feats):
    """(the part's callable on its inputs, the inputs that need a
    gradient)."""
    with torch.no_grad():
        queries = ref.query_encoder(p, dims, b["word_ids"], b["query_mask"])
        levels = ref.backbone(p, dims, feats)
        fused = ref.fusion(p, dims, levels, queries)
        pyramid = ref.fpn(p, dims, fused)
        d_s, d_e, _ = ref.heads(p, dims, pyramid)
        segs = ref.decode(dims, d_s, d_e)
    calls = {
        "query_encoder": lambda: ref.query_encoder(p, dims, b["word_ids"],
                                                   b["query_mask"]),
        "backbone": lambda: ref.backbone(p, dims, feats),
        "fusion": lambda: ref.fusion(p, dims, levels, queries),
        "fpn": lambda: ref.fpn(p, dims, fused),
        "heads": lambda: ref.heads(p, dims, pyramid),
        "iou_head": lambda: ref.iou_head(p, dims, pyramid, segs),
    }
    return calls[part], {"query_encoder": [], "backbone": [],
                         "fusion": levels + queries, "fpn": fused,
                         "heads": pyramid, "iou_head": pyramid}[part]


def flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("part", spec.parts())
def test_forward_count_equals_the_flop_counter(part):
    dims = spec.dims(tiny_conf())
    p, b, feats = inputs(dims)
    call, _ = part_call(part, p, dims, b, feats)
    with torch.no_grad():
        counted = flops(call)
    assert spec.work(part).forward(dims, BATCH)["flops"] == counted


@pytest.mark.parametrize("part", [p for p in spec.parts() if p != "iou_head"])
def test_training_count_equals_the_flop_counter(part):
    """Forward, dX and dW; the parts upstream of a part's input are trained
    in stage 1, so its input's gradient is model work too."""
    dims = spec.dims(tiny_conf())
    p, b, feats = inputs(dims)
    call, acts = part_call(part, p, dims, b, feats)
    leaves = [v.requires_grad_() for k, v in p.items()
              if not k.endswith("bias_hh_l0")]
    acts = [a.clone().requires_grad_() for a in acts]
    if part == "backbone":
        call = lambda: ref.backbone(p, dims, feats)  # noqa: E731
    elif acts:
        fn = {"fusion": lambda x: ref.fusion(p, dims, x[:len(x) // 2],
                                             x[len(x) // 2:]),
              "fpn": lambda x: ref.fpn(p, dims, x),
              "heads": lambda x: ref.heads(p, dims, x)}[part]
        call = lambda: fn(acts)  # noqa: E731

    def fwd_bwd():
        out = call()
        loss = sum(o.float().sum() for o in out)
        torch.autograd.grad(loss, leaves + acts, allow_unused=True)

    assert spec.work(part).train(dims, BATCH, 1)["flops"] == flops(fwd_bwd)


def test_the_iou_head_is_forward_only_in_stage_one():
    dims = spec.dims(tiny_conf())
    w = spec.work("iou_head")
    assert w.train(dims, BATCH, 1) == w.forward(dims, BATCH)
    assert w.train(dims, BATCH, 2)["flops"] == 3 * w.forward(dims, BATCH)["flops"]
