"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and `nvcc` (the kernels are built from
drn_tpu_torch/ops/cuda/csrc at first use); without a card they skip. On
the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which that machine
lacks; nothing here needs it.)

Tolerance: both sides multiply bf16 inputs, sum in fp32 in another order
and round the output to bf16 once: two bf16 ulps relative plus 1/64
absolute. chip_smoke.py checks the same at the flagship shapes. Gradients:
the kernels' autograd Functions against autograd of the plain versions;
the Functions round the LayerNorm's cotangent to bf16 before the conv's
VJP, the plain versions keep it in fp32, so each gradient is held by its
relative L2 error, ≤ 2e-2 (a few bf16 ulps of 2^-8 over the tensor).
"""

import dataclasses

import numpy as np
import pytest
import torch

from drn_tpu_torch.ops.cuda import (conv_ln_relu, fused_fusion_block,
                                    fused_stem, launch_counts)
from drn_tpu_torch.ops.cuda.autograd import (ConvLnReluFn,
                                             FusedFusionBlockFn,
                                             FusedFusionFn, FusedStemFn)
from drn_tpu_torch.ops.cuda.conv_block import (conv_ln_relu_reference,
                                               conv_plan)
from drn_tpu_torch.ops.cuda.fused_fusion import (fused_fusion,
                                                 fused_fusion_block_reference,
                                                 fused_fusion_reference)
from drn_tpu_torch.ops.cuda.stem import fused_stem_reference, stem_plan

pytestmark = pytest.mark.cuda
TOL = dict(atol=1 / 64, rtol=1 / 64)
GRAD_REL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, dtype=torch.bfloat16, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


def _epilogue(dev, cout):
    return (_randn(dev, cout, scale=0.1, seed=1).float(),
            1.0 + _randn(dev, cout, scale=0.1, dtype=torch.float32, seed=2),
            _randn(dev, cout, scale=0.1, dtype=torch.float32, seed=3))


# Every width the kernel instantiates x K 1 and 3 at strides 1 and 2 x T
# 64, 57 (odd: stride 2 pads 1 row on each side), 114 (the towers' gap
# concat: tiles across video boundaries, a ragged last tile), 16 x Cin 512
# with LayerNorm and ReLU, 1536 (IoU mix_0) without ReLU (the laterals),
# 128 without either (the backward's recompute); then the earlier cases,
# and activitynet_c3d's Cin 500 (rows not 16-byte aligned in bf16, a last
# channel vector that runs past Cin). K 1 at stride 1 with aligned rows
# takes A by TMA, every other case A by cp.async.
CONV_CASES = [(t, cin, cout, k, stride, norm, act)
              for cout in (64, 128, 256, 512)
              for k, stride in ((1, 1), (3, 1), (3, 2), (1, 2))
              for t in (64, 57, 114, 16)
              for cin, norm, act in ((512, True, True), (1536, True, False),
                                     (128, False, False))] + [
    (64, 512, 512, 3, 1, True, True),
    (64, 512, 512, 3, 2, True, True),
    (57, 128, 128, 3, 2, False, True),   # ragged T, odd length
    (114, 256, 512, 3, 1, True, True),   # the heads' gap concat
    (112, 1536, 512, 1, 1, True, True),  # IoU mix_0
    (33, 64, 64, 1, 1, True, False),
    (37, 500, 512, 3, 1, True, True),
    (37, 500, 512, 3, 2, True, True),
    (37, 500, 512, 1, 1, True, True),    # k=1 without A by TMA
]


@pytest.mark.parametrize("t,cin,cout,k,stride,use_norm,use_act", CONV_CASES)
def test_conv_ln_relu_kernel(dev, t, cin, cout, k, stride, use_norm,
                             use_act):
    x = _randn(dev, 6, t, cin)
    w = _randn(dev, k, cin, cout, scale=(k * cin) ** -0.5, seed=4)
    args = (x, w, *_epilogue(dev, cout), stride, use_norm, use_act)
    before = launch_counts()["conv_ln_relu"]
    got = conv_ln_relu(*args)
    torch.cuda.synchronize()
    assert launch_counts()["conv_ln_relu"] == before + 1
    torch.testing.assert_close(got.float(),
                               conv_ln_relu_reference(*args).float(), **TOL)


@pytest.mark.parametrize("t", [64, 16, 21])
def test_fused_fusion_block_kernel(dev, t):
    d = 512
    v, q = _randn(dev, 6, t, d), _randn(dev, 6, d, scale=0.5, seed=5)
    w = _randn(dev, 3, d, d, scale=(3 * d) ** -0.5, seed=6)
    args = (v, q, w, *_epilogue(dev, d))
    torch.testing.assert_close(
        fused_fusion_block(*args).float(),
        fused_fusion_block_reference(*args).float(), **TOL)


@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("t", [64, 57, 256])
@pytest.mark.parametrize("cin", [4096, 1024, 500, 256])
@pytest.mark.parametrize("cout", [64, 128, 256, 512])
def test_fused_stem_kernel(dev, cout, cin, t, use_norm):
    """Every width the kernel instantiates; Cin 500 (activitynet_c3d: a
    ragged last k-tile), T 57 (M = 4·57 not a multiple of the 64-row tile,
    tiles across video boundaries); LayerNorm and ReLU off as in the
    backward's recompute. Features with a large mean test the input
    LayerNorm's fast-variance clamp."""
    x = _randn(dev, 4, t, cin, scale=3.0, dtype=torch.float32) + 0.5
    args = (x, 1.0 + _randn(dev, cin, scale=0.1, dtype=torch.float32, seed=7),
            _randn(dev, cin, scale=0.1, dtype=torch.float32, seed=8),
            _randn(dev, 3, cin, cout, scale=(3 * cin) ** -0.5, seed=9),
            *_epilogue(dev, cout), torch.bfloat16, use_norm, use_norm)
    before = launch_counts()["fused_stem"]
    got = fused_stem(*args)
    torch.cuda.synchronize()
    assert launch_counts()["fused_stem"] == before + 1
    torch.testing.assert_close(got.float(),
                               fused_stem_reference(*args).float(), **TOL)


@pytest.mark.parametrize("split", [2, 1])
def test_fused_stem_kernel_at_the_split_boundary(dev, split):
    """Cout 512 at the most row tiles that are still split over a 2-block
    cluster (half the card's SMs) and at one more (one block a tile);
    both against the plain version."""
    cin, cout = 256, 512
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = sms // 2 + (split == 1)  # one 64-row tile a video
    assert stem_plan(b * 64, cin, cout, 3, sms).split == split
    x = _randn(dev, b, 64, cin, scale=3.0, dtype=torch.float32) + 0.5
    args = (x, 1.0 + _randn(dev, cin, scale=0.1, dtype=torch.float32, seed=7),
            _randn(dev, cin, scale=0.1, dtype=torch.float32, seed=8),
            _randn(dev, 3, cin, cout, scale=(3 * cin) ** -0.5, seed=9),
            *_epilogue(dev, cout), torch.bfloat16)
    torch.testing.assert_close(fused_stem(*args).float(),
                               fused_stem_reference(*args).float(), **TOL)


# Both fusion kernels (conv_sm90.cuh's Hadamard variant) at every width
# they instantiate x K 1 (never A by TMA: that would copy v without q), 3
# and 5 x T 64, 21 (ragged: tiles across videos) and 16 (a 64-row tile
# spans 5 videos) x D 512 and 500 (rows not 16-byte aligned: v and q
# channel by channel).
FUSION_CASES = [(name, t, d, dout, k)
                for name in ("fused_fusion_block", "fused_fusion")
                for dout in (64, 128, 256, 512) for k in (1, 3, 5)
                for t in (64, 21, 16) for d in (512, 500)]


def _fusion_args(dev, name, b, t, d, dout, k):
    v, q = _randn(dev, b, t, d), _randn(dev, b, d, scale=0.5, seed=5)
    w = _randn(dev, k, d, dout, scale=(k * d) ** -0.5, seed=6)
    epi = _epilogue(dev, dout)
    return (v, q, w, *(epi if name == "fused_fusion_block" else epi[:1]))


@pytest.mark.parametrize("name,t,d,dout,k", FUSION_CASES)
def test_fusion_kernels(dev, name, t, d, dout, k):
    from drn_tpu_torch.ops.cuda import fused_fusion as ff

    args = _fusion_args(dev, name, 6, t, d, dout, k)
    before = launch_counts()[name]
    got = getattr(ff, name)(*args)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    torch.testing.assert_close(
        got.float(), getattr(ff, name + "_reference")(*args).float(), **TOL)


@pytest.mark.parametrize("split,part,more", [(4, 4, 0), (2, 4, 1), (2, 2, 0),
                                             (1, 2, 1)])
def test_fusion_kernels_at_the_split_boundaries(dev, split, part, more):
    """Dout 512 at the most row tiles that are still split over a 4-block
    cluster, over a 2-block one, and one tile more than each, as the conv
    block's test: with the LayerNorm (fused_fusion_block, row sums across
    the cluster) and without (fused_fusion)."""
    from drn_tpu_torch.ops.cuda import fused_fusion as ff

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = sms // part + more  # one 64-row tile a video
    assert conv_plan(b * 64, 512, sms).split == split
    for name in ("fused_fusion_block", "fused_fusion"):
        args = _fusion_args(dev, name, b, 64, 128, 512, 3)
        torch.testing.assert_close(
            getattr(ff, name)(*args).float(),
            getattr(ff, name + "_reference")(*args).float(), **TOL)


def test_every_kernel_launches_from_a_new_thread(dev):
    """A thread whose first CUDA call is one of the port's launches, as
    autograd's backward thread is where a Function's backward starts with
    a kernel (FusedFusionBlockFn's recompute): each kernel launches there
    and agrees with its plain version."""
    import threading

    from drn_tpu_torch.ops.cuda import fused_fusion as ff
    from drn_tpu_torch.ops.cuda import pallas_block, pallas_block_reference

    x, v = _randn(dev, 2, 64, 128), _randn(dev, 2, 64, 512)
    q = _randn(dev, 2, 512, seed=5)
    w = _randn(dev, 3, 128, 512, scale=0.05, seed=4)
    wf = _randn(dev, 3, 512, 512, scale=0.03, seed=6)
    epi = _epilogue(dev, 512)
    xs = _randn(dev, 2, 64, 128, dtype=torch.float32, seed=7)
    ones, zeros = torch.ones_like(epi[1][:128]), torch.zeros_like(epi[1][:128])
    calls = {
        "conv_ln_relu": ((x, w, *epi), conv_ln_relu, conv_ln_relu_reference),
        "fused_stem": ((xs, ones, zeros, w, *epi, torch.bfloat16), fused_stem,
                       fused_stem_reference),
        "fused_fusion": ((v, q, wf, epi[0]), ff.fused_fusion,
                         ff.fused_fusion_reference),
        "fused_fusion_block": ((v, q, wf, *epi), ff.fused_fusion_block,
                               ff.fused_fusion_block_reference),
        "pallas_block": ((v, q, wf, epi[0].bfloat16(), *epi[1:], 1e-6),
                         pallas_block, pallas_block_reference),
    }
    for name, (args, kernel, plain) in calls.items():
        got = {}

        def run():
            try:
                with torch.no_grad():
                    got["out"] = kernel(*args)
                torch.cuda.synchronize()
            except Exception as e:  # reported below, on the test's thread
                got["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        assert "error" not in got, (name, got.get("error"))
        torch.testing.assert_close(got["out"].float(),
                                   plain(*args).float(), **TOL)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = _randn(dev, 2, 16, 64)
    w = _randn(dev, 3, 64, 64)
    b, s, o = _epilogue(dev, 64)
    xf, ones, zeros = x.float(), s[:64].clone(), o[:64].clone()
    with pytest.raises(ValueError):                      # Cout not built
        fused_stem(xf, ones, zeros, _randn(dev, 3, 64, 96), *_epilogue(dev, 96))
    with pytest.raises(ValueError):                      # even K
        fused_stem(xf, ones, zeros, _randn(dev, 2, 64, 64), b, s, o)
    with pytest.raises(TypeError):                       # bf16 features
        fused_stem(x, ones, zeros, w, b, s, o)
    with pytest.raises(TypeError):
        conv_ln_relu(x.float(), w, b, s, o)              # fp32 activations
    with pytest.raises(ValueError):
        conv_ln_relu(x[:, ::2], w, b, s, o)              # not contiguous
    with pytest.raises(ValueError):                      # Cout not built
        conv_ln_relu(x, _randn(dev, 3, 64, 60), *_epilogue(dev, 60))
    with pytest.raises(RuntimeError):
        conv_ln_relu(x, w.clone().requires_grad_(), b, s, o)
    q = _randn(dev, 2, 64)
    for fusion, epi in ((fused_fusion_block, (s, o)), (fused_fusion, ())):
        with pytest.raises(ValueError):                  # even K
            fusion(x, q, _randn(dev, 2, 64, 64), b, *epi)
        with pytest.raises(ValueError):                  # K past MAX_K
            fusion(x, q, _randn(dev, 19, 64, 64), b, *epi)
        with pytest.raises(ValueError):                  # Cout not built
            fusion(x, q, _randn(dev, 3, 64, 96), *_epilogue(dev, 96)[
                :1 + len(epi)])
        with pytest.raises(TypeError):                   # fp32 v
            fusion(x.float(), q, w, b, *epi)
    from drn_tpu_torch.ops.cuda import pallas_block
    bb = b.bfloat16()
    with pytest.raises(ValueError):                      # K past MAX_K
        pallas_block(x, q, _randn(dev, 18, 64, 64), bb, s, o)
    with pytest.raises(ValueError):                      # Cout not built
        pallas_block(x, q, _randn(dev, 3, 64, 96), _randn(dev, 96),
                     *_epilogue(dev, 96)[1:])
    with pytest.raises(TypeError):                       # fp32 v
        pallas_block(x.float(), q, w, bb, s, o)
    with pytest.raises(TypeError):                       # fp32 bias
        pallas_block(x, q, w, b, s, o)
    # A split or grid the source does not build, or K past kMaxK: the entry
    # point refuses.
    from drn_tpu_torch.ops.cuda import _build
    from drn_tpu_torch.ops.cuda.conv_block import stream_of
    out = torch.empty_like(x)
    fn = _build.entry("fused_fusion", "drn_fused_fusion", 5, 7)
    ptrs = [t.data_ptr() for t in (x, q, w, b, out)]
    assert fn(*ptrs, 2, 16, 64, 64, 3, 1, 1, stream_of(x)) == 0  # the plan
    for split, grid in ((2, 2), (1, 2), (3, 3), (4, 4)):  # 64 columns: 1
        assert fn(*ptrs, 2, 16, 64, 64, 3, split, grid, stream_of(x)) != 0
    fn = _build.entry("block_probe", "drn_pallas_block", 7, 7, 1)
    ptrs = [t.data_ptr() for t in (x, q, w, bb, s, o, out)]
    assert fn(*ptrs, 2, 16, 64, 64, 3, 1, 1, 1e-6, stream_of(x)) == 0
    for k, split, grid in ((3, 2, 2), (3, 1, 2), (3, 3, 3), (3, 4, 4),
                           (18, 1, 1)):
        assert fn(*ptrs, 2, 16, 64, 64, k, split, grid, 1e-6,
                  stream_of(x)) != 0
    torch.cuda.synchronize()


def test_eval_step_kernels_vs_plain(dev):
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, evaluate
    from drn_tpu_torch.models.layers import PLAIN_OPS

    cfg = get_config("synthetic_tiny")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               synthetic_examples=16))
    model = build_model(cfg, seed=1)
    plain = build_model(cfg, seed=1, ops=PLAIN_OPS)
    got, want = evaluate(cfg, model), evaluate(cfg, plain)
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("t", [64, 16])
def test_fused_fusion_kernel(dev, t):
    d = 512
    v, q = _randn(dev, 6, t, d), _randn(dev, 6, d, scale=0.5, seed=5)
    w = _randn(dev, 3, d, d, scale=(3 * d) ** -0.5, seed=6)
    b = _randn(dev, d, scale=0.1, seed=1).float()
    before = launch_counts()["fused_fusion"]
    got = fused_fusion(v, q, w, b)
    torch.cuda.synchronize()
    assert launch_counts()["fused_fusion"] == before + 1
    torch.testing.assert_close(got.float(),
                               fused_fusion_reference(v, q, w, b).float(),
                               **TOL)


@pytest.mark.parametrize("split,part,more", [(4, 4, 0), (2, 4, 1), (2, 2, 0),
                                             (1, 2, 1)])
def test_conv_ln_relu_kernel_at_the_split_boundaries(dev, split, part, more):
    """Cout 512 at the most row tiles that are still split over a 4-block
    cluster (a quarter of the card's SMs), over a 2-block one (half), and
    one tile more than each; against the plain version, with LayerNorm
    (whose row sums cross the cluster) and without."""
    cin, cout = 128, 512
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = sms // part + more  # one 64-row tile a video
    assert conv_plan(b * 64, cout, sms).split == split
    x = _randn(dev, b, 64, cin)
    w = _randn(dev, 3, cin, cout, scale=(3 * cin) ** -0.5, seed=4)
    for use_norm in (True, False):
        args = (x, w, *_epilogue(dev, cout), 1, use_norm, use_norm)
        torch.testing.assert_close(conv_ln_relu(*args).float(),
                                   conv_ln_relu_reference(*args).float(),
                                   **TOL)


def _grads_vs_plain(fn, plain, args, shape_out, dev):
    """fn.apply(*args) backward vs autograd of plain(*args), same g."""
    g = _randn(dev, *shape_out, seed=20)
    grads = []
    for f in (fn.apply, plain):
        leaves = [a.detach().clone().requires_grad_(a.is_floating_point())
                  if isinstance(a, torch.Tensor) else a for a in args]
        f(*leaves).backward(g)
        grads.append([a.grad for a in leaves if isinstance(a, torch.Tensor)])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        err = ((got.float() - want.float()).norm()
               / want.float().norm().clamp_min(1e-30)).item()
        assert err <= GRAD_REL, err


@pytest.mark.parametrize("t,cin,k,stride", [(64, 512, 3, 1), (64, 512, 3, 2),
                                            (57, 128, 3, 2),
                                            (112, 1536, 1, 1)])
def test_conv_ln_relu_backward_vs_plain(dev, t, cin, k, stride):
    d = 512
    args = (_randn(dev, 6, t, cin), _randn(dev, k, cin, d,
                                           scale=(k * cin) ** -0.5, seed=4),
            *_epilogue(dev, d), stride, True, True)
    _grads_vs_plain(ConvLnReluFn, conv_ln_relu_reference, args,
                    (6, -(-t // stride), d), dev)


def test_fused_fusion_block_and_fused_fusion_backward_vs_plain(dev):
    d, t = 512, 64
    v, q = _randn(dev, 6, t, d), _randn(dev, 6, d, scale=0.5, seed=5)
    w = _randn(dev, 3, d, d, scale=(3 * d) ** -0.5, seed=6)
    _grads_vs_plain(FusedFusionBlockFn, fused_fusion_block_reference,
                    (v, q, w, *_epilogue(dev, d)), (6, t, d), dev)
    _grads_vs_plain(FusedFusionFn, fused_fusion_reference,
                    (v, q, w, _epilogue(dev, d)[0]), (6, t, d), dev)


@pytest.mark.parametrize("cin", [1024, 500])
def test_fused_stem_backward_vs_plain(dev, cin):
    d = 512
    x = _randn(dev, 4, 64, cin, scale=3.0, dtype=torch.float32) + 0.5
    args = (x, 1.0 + _randn(dev, cin, scale=0.1, dtype=torch.float32, seed=7),
            _randn(dev, cin, scale=0.1, dtype=torch.float32, seed=8),
            _randn(dev, 3, cin, d, scale=(3 * cin) ** -0.5, seed=9),
            *_epilogue(dev, d), torch.bfloat16)
    _grads_vs_plain(FusedStemFn, fused_stem_reference, args, (4, 64, d), dev)


def test_train_step_kernels_vs_plain(dev):
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.evaluate import build_model, to_device
    from drn_tpu_torch.models.layers import PLAIN_OPS
    from drn_tpu_torch.train import loss_and_grads

    cfg = get_config("synthetic_tiny")
    batch = to_device(next(BatchIterator(make_dataset(cfg.data, cfg.model),
                                         8, shuffle=False).epoch(0)), dev)
    losses, grads = [], []
    for ops in (None, PLAIN_OPS):
        model = (build_model(cfg, seed=1, ops=ops) if ops
                 else build_model(cfg, seed=1)).train()
        losses.append(loss_and_grads(cfg, model, batch)["loss"].item())
        grads.append({k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None})
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 0.02 * abs(losses[1])
    assert set(grads[0]) == set(grads[1])


# The probe's block (conv_sm90.cuh's Hadamard variant) at its first four
# cases (D 512, Dout 512), then every width it instantiates x K 1 to 5 (odd
# and even: K // 2 rows of left padding) x T 64, 21 (tiles across videos)
# and 16 (a tile spans 5 videos) at D 512, and D 500 (rows not 16-byte
# aligned) at K 3 and 4.
PALLAS_BLOCK_CASES = [
    pytest.param(b, t, 512, 512, k, id=f"{b}-{t}-{k}")
    for b, t, k in ((32, 64, 3), (8, 21, 3), (16, 64, 4), (8, 21, 2))] + [
    pytest.param(6, t, d, dout, k, id=f"6-{t}-{k}-d{d}-dout{dout}")
    for d, dout, ks in [(512, dout, (1, 2, 3, 4, 5)) for dout in
                        (64, 128, 256, 512)] + [(500, 512, (3, 4))]
    for k in ks for t in (64, 21, 16)]


def _pallas_block_args(dev, b, t, d, dout, k):
    v, q = _randn(dev, b, t, d), _randn(dev, b, d, seed=5)
    w = _randn(dev, k, d, dout, scale=0.05, seed=6)
    bias = _randn(dev, dout, scale=0.1, seed=1)
    _, scale, offset = _epilogue(dev, dout)
    return v, q, w, bias, scale, offset


@pytest.mark.parametrize("b,t,d,dout,k", PALLAS_BLOCK_CASES)
def test_pallas_block_kernel(dev, b, t, d, dout, k):
    """The probe's block: bf16 bias, its own eps, K // 2 rows of left
    padding for odd and even K."""
    from drn_tpu_torch.ops.cuda import pallas_block, pallas_block_reference

    v, q, w, bias, scale, offset = _pallas_block_args(dev, b, t, d, dout, k)
    for eps in (1e-6, 1e-3):
        before = launch_counts()["pallas_block"]
        got = pallas_block(v, q, w, bias, scale, offset, eps)
        torch.cuda.synchronize()
        assert launch_counts()["pallas_block"] == before + 1
        torch.testing.assert_close(
            got.float(), pallas_block_reference(v, q, w, bias, scale, offset,
                                                eps).float(), **TOL)


@pytest.mark.parametrize("split,part,more", [(4, 4, 0), (2, 4, 1), (2, 2, 0),
                                             (1, 2, 1)])
def test_pallas_block_kernel_at_the_split_boundaries(dev, split, part, more):
    """Dout 512 at the most row tiles still split over a 4-block cluster
    (33 on an H100), over a 2-block one (66), and one tile more than each:
    the LayerNorm's row sums cross the cluster, at an even K."""
    from drn_tpu_torch.ops.cuda import pallas_block, pallas_block_reference

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = sms // part + more  # one 64-row tile a video
    assert conv_plan(b * 64, 512, sms).split == split
    args = _pallas_block_args(dev, b, 64, 128, 512, 4)
    torch.testing.assert_close(pallas_block(*args, 1e-3).float(),
                               pallas_block_reference(*args, 1e-3).float(),
                               **TOL)


def test_flops_equal_through_kernels_and_plain_versions(dev):
    """One eval step's matmul + conv FLOPs: the kernels report theirs, the
    plain versions' products are counted by FlopCounterMode; and the cuDNN
    LSTM counts what the CPU's does."""
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.evaluate import build_model, make_eval_step, to_device
    from drn_tpu_torch.models.layers import KERNEL_OPS, PLAIN_OPS
    from drn_tpu_torch.utils.flops import estimate_flops

    cfg = get_config("synthetic_tiny")
    batch = to_device(next(BatchIterator(
        make_dataset(cfg.data, cfg.model, split="test"), 8,
        shuffle=False).epoch(0)), dev)
    counts = [estimate_flops(make_eval_step(
        cfg, build_model(cfg, seed=1, ops=ops)), batch)
        for ops in (KERNEL_OPS, PLAIN_OPS)]
    assert counts[0] == counts[1] > 0
    lstm = torch.nn.LSTM(16, 8, num_layers=2, bidirectional=True,
                         batch_first=True)
    x = torch.randn(4, 7, 16)
    want = estimate_flops(lstm, x)
    assert estimate_flops(lstm.to(dev), x.to(dev)) == want
