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
from drn_tpu_torch.ops.cuda.conv_block import (conv_ln_relu_bwd,
                                               conv_ln_relu_bwd_reference,
                                               conv_ln_relu_reference,
                                               conv_plan)
from drn_tpu_torch.ops.cuda.fused_fusion import (
    fused_fusion, fused_fusion_block_bwd, fused_fusion_block_bwd_reference,
    fused_fusion_block_reference, fused_fusion_reference)
from drn_tpu_torch.ops.cuda.nms_sweep import (MAX_K, nms_sweep,
                                              nms_sweep_reference)
from drn_tpu_torch.ops.cuda.stem import fused_stem_reference, stem_plan
from drn_tpu_torch.probes.nms_probe import SWEEP_KINDS, sweep_inputs

from torch_threads import one_torch_thread  # noqa: F401

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


def _sweep_segs(dev, b, k, kind, thr=0.5, seed=0):
    return torch.from_numpy(sweep_inputs(b, k, kind, thr, seed)).to(dev)


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
        "nms_sweep": ((_sweep_segs(dev, 2, 48, "random"), 0.5), nms_sweep,
                      nms_sweep_reference),
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
    g = _randn(dev, 2, 16, 64)
    with pytest.raises(TypeError):                       # fp32 cotangent
        conv_ln_relu_bwd(x, w, b, s, o, g.float())
    with pytest.raises(ValueError):                      # g of stride 1
        conv_ln_relu_bwd(x, w, b, s, o, g, 2)
    q = _randn(dev, 2, 64)
    with pytest.raises(ValueError):                      # even K
        fused_fusion_block_bwd(x, q, _randn(dev, 2, 64, 64), b, s, o, g)
    with pytest.raises(TypeError):                       # fp32 cotangent
        fused_fusion_block_bwd(x, q, w, b, s, o, g.float())
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
    # The backward takes one block a row tile, never a cluster.
    bwd = _build.entry("conv_block", "drn_conv_ln_relu_bwd", 11, 10)
    f32 = [torch.empty(n, device=dev) for n in (3 * 64, 64, 64, 64)]
    ptrs = [t.data_ptr() for t in (x, w, b, s, o, g, out, *f32)]
    assert bwd(*ptrs, 2, 16, 64, 64, 3, 1, 16, 1, 1, 1, stream_of(x)) == 0
    for grid in (2, 0):
        assert bwd(*ptrs, 2, 16, 64, 64, 3, 1, 16, 1, 1, grid,
                   stream_of(x)) != 0
    fn = _build.entry("block_probe", "drn_pallas_block", 7, 7, 1)
    ptrs = [t.data_ptr() for t in (x, q, w, bb, s, o, out)]
    assert fn(*ptrs, 2, 16, 64, 64, 3, 1, 1, 1e-6, stream_of(x)) == 0
    for k, split, grid in ((3, 2, 2), (3, 1, 2), (3, 3, 3), (3, 4, 4),
                           (18, 1, 1)):
        assert fn(*ptrs, 2, 16, 64, 64, k, split, grid, 1e-6,
                  stream_of(x)) != 0
    torch.cuda.synchronize()


# The NMS sweep at every warp boundary of K, DRN's K = 48 and 2D-TAN's
# 2,548, one query and a 2D-TAN step's 128.
@pytest.mark.parametrize("b,k", [(b, k) for b in (1, 128)
                                 for k in (1, 31, 32, 33, 48, 2548)])
def test_nms_sweep_kernel_equals_plain(dev, b, k):
    """The keep mask of one launch equals the plain version's bit for bit
    (on the card, and on the CPU for one query), on random, tie-heavy
    grid and suppression-chain inputs at each threshold."""
    for kind in SWEEP_KINDS:
        for thr in (0.3, 0.5, 0.7):
            segs = _sweep_segs(dev, b, k, kind, thr, seed=b + k)
            want = nms_sweep_reference(segs, thr)
            before = launch_counts()["nms_sweep"]
            got = nms_sweep(segs, thr)
            assert launch_counts()["nms_sweep"] == before + 1
            assert torch.equal(got, want), (kind, thr)
            if b == 1:
                assert torch.equal(got.cpu(), nms_sweep_reference(
                    segs.cpu(), thr)), (kind, thr)


def test_nms_sweep_kernel_past_48kb_and_what_it_refuses(dev):
    """K = 8,192 and MAX_K take more than 48 KB of shared memory a block;
    K above MAX_K, fp32 only, contiguous only; the entry point's own
    refusal."""
    for k in (8192, MAX_K):
        segs = _sweep_segs(dev, 3, k, "random", seed=k)
        assert torch.equal(nms_sweep(segs, 0.5),
                           nms_sweep_reference(segs, 0.5)), k
    with pytest.raises(ValueError, match="MAX_K"):
        nms_sweep(torch.zeros(1, MAX_K + 1, 2, device=dev), 0.5)
    segs = _sweep_segs(dev, 2, 48, "grid")
    with pytest.raises(ValueError):
        nms_sweep(segs.double(), 0.5)
    with pytest.raises(ValueError):
        nms_sweep(segs[:, ::2], 0.5)
    # Past the shared memory the card gives a block, the entry point
    # refuses, and the next launch finds no error left pending.
    from drn_tpu_torch.ops.cuda import _build
    from drn_tpu_torch.ops.cuda.conv_block import stream_of
    big = torch.zeros(1, 2 * MAX_K, 2, device=dev)
    keep = torch.empty(1, 2 * MAX_K, dtype=torch.bool, device=dev)
    fn = _build.entry("nms_sweep", "drn_nms_sweep", 2, 3, 1)
    assert fn(big.data_ptr(), keep.data_ptr(), 1, 2 * MAX_K, 1024, 0.5,
              stream_of(big)) != 0
    assert torch.equal(nms_sweep(segs, 0.5), nms_sweep_reference(segs, 0.5))
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


# The backward kernels (conv_sm90.cuh's backward epilogue) against their
# plain versions, which recompute the conv in fp32 on the card: the four
# shapes above (stride 2 and T = 57 gather A by cp.async, K = 1 with Cin
# 1536 takes it by TMA), K = 1 without the ReLU (the laterals), the other
# widths the template builds at a ragged last tile, and the fusion block's
# shape (the Hadamard A). Each output by its relative L2 error: dpre is the
# VJP at the fp32 accumulator rounded once to bf16 on both sides, the fp32
# sums differ in order.
BWD_CASES = [("conv", 6, t, cin, 512, k, stride, True)
             for t, cin, k, stride in ((64, 512, 3, 1), (64, 512, 3, 2),
                                       (57, 128, 3, 2), (112, 1536, 1, 1))] + [
    ("conv", 6, 64, 512, 512, 1, 1, False),
    ("conv", 5, 57, 128, 64, 3, 1, True),
    ("conv", 5, 57, 256, 128, 3, 2, False),
    ("conv", 5, 57, 512, 256, 3, 1, True),
    ("fusion", 6, 64, 512, 512, 3, 1, True)]


def _bwd_args(dev, kind, b, t, cin, cout, k, stride, use_act):
    x = _randn(dev, b, t, cin)
    w = _randn(dev, k, cin, cout, scale=(k * cin) ** -0.5, seed=4)
    g = _randn(dev, b, -(-t // stride), cout, seed=20)
    if kind == "fusion":
        q = _randn(dev, b, cin, scale=0.5, seed=5)
        return (fused_fusion_block_bwd, fused_fusion_block_bwd_reference,
                (x, q, w, *_epilogue(dev, cout), g))
    return (conv_ln_relu_bwd, conv_ln_relu_bwd_reference,
            (x, w, *_epilogue(dev, cout), g, stride, use_act))


@pytest.mark.parametrize("kind,b,t,cin,cout,k,stride,use_act", BWD_CASES)
def test_backward_kernels_vs_plain(dev, kind, b, t, cin, cout, k, stride,
                                   use_act):
    fn, plain, args = _bwd_args(dev, kind, b, t, cin, cout, k, stride,
                                use_act)
    name = fn.__name__
    before = launch_counts()[name]
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        err = ((gt.float() - wt.float()).norm()
               / wt.float().norm().clamp_min(1e-30)).item()
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("kind", ["conv", "fusion"])
def test_backward_kernels_sum_the_same_every_run(dev, kind):
    """dscale, doffset and db are reduced without atomics: two runs give
    the same bits (and dpre too)."""
    fn, _, args = _bwd_args(dev, kind, 48, 64, 512, 512, 3, 1, True)
    first, second = fn(*args), fn(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_train_step_launches_one_backward_kernel_a_block(dev):
    """One stage-1 step of the flagship model: each of its 15 conv blocks
    and 3 fusion blocks takes its LayerNorm+ReLU VJP in one backward
    launch; an eval step launches neither."""
    from drn_tpu_torch.bench import make_bench_batch
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, make_eval_step
    from drn_tpu_torch.train import loss_and_grads

    cfg = get_config("charades_c3d")
    batch = make_bench_batch(cfg, batch_size=8, device=dev)
    model = build_model(cfg, device=dev, seed=0).train()
    names = ("conv_ln_relu_bwd", "fused_fusion_block_bwd")
    before = launch_counts()
    loss = loss_and_grads(cfg, model, batch)["loss"]
    assert torch.isfinite(loss)
    after = launch_counts()
    assert [after[n] - before[n] for n in names] == [15, 3]
    with torch.no_grad():
        make_eval_step(cfg, model.eval())(batch)
    torch.cuda.synchronize()
    assert [launch_counts()[n] - after[n] for n in names] == [0, 0]


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


# --- the real-dataset path on the card -----------------------------------


def _corpus_config(root, glove=False):
    """synthetic_tiny over a small Charades-STA corpus written from a seed
    (raw lengths 1..60 rows, some float16 files), optionally with a 300-d
    GloVe file that lacks two of the corpus words."""
    from drn_tpu_torch.config import get_config

    rng = np.random.default_rng(7)
    words = "person opens the door closes a window sits someone laughs".split()
    fd = root / "feats"
    fd.mkdir()
    lines = []
    for v in range(6):
        t = [32, 1, 60, 17, 45, 9][v]
        np.save(fd / f"C{v}.npy", rng.normal(size=(t, 128)).astype(
            np.float16 if v % 2 else np.float32))
        for _ in range(3):
            s = float(rng.uniform(0, t * 0.5))
            sent = " ".join(rng.choice(words, int(rng.integers(2, 7))))
            lines.append(f"C{v} {s:.2f} {s + t * 0.3:.2f}##{sent}\n")
    (root / "charades_sta_train.txt").write_text("".join(lines))
    (root / "charades_sta_test.txt").write_text("".join(lines[:12]))
    data = dict(dataset="charades", feature_dir=str(fd), feature_fps=2.0,
                annotation_path=str(root / "charades_sta_{split}.txt"),
                batch_size=8)
    if glove:
        with open(root / "glove.txt", "w") as f:
            for w in words[:-2]:
                f.write(w + " " + " ".join(
                    f"{x:.5f}" for x in rng.normal(size=300)) + "\n")
        data["glove_path"] = str(root / "glove.txt")
    cfg = get_config("synthetic_tiny")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, **data),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(root / "ck"),
                                  eval_every_epochs=0))


def test_staged_gather_on_the_card_equals_the_streamed_batch(dev, tmp_path):
    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.evaluate import (batch_features, stage_on_device,
                                        to_device)

    cfg = _corpus_config(tmp_path)
    ds = make_dataset(cfg.data, cfg.model, split="train")
    table, view = stage_on_device(ds, dev)
    assert table.device.type == "cuda" and table.shape == (6, 32, 128)
    for full, light in zip(BatchIterator(ds, 8, shuffle=False).epoch(0),
                           BatchIterator(view, 8, shuffle=False).epoch(0)):
        got = batch_features(to_device(light, dev), table)
        assert got.device.type == "cuda"
        valid = full["valid"]
        assert torch.equal(got.cpu()[torch.from_numpy(valid)],
                           torch.from_numpy(full["features"][valid]))


def test_staged_evaluate_equals_streamed_on_the_card(dev, tmp_path):
    from drn_tpu_torch.evaluate import build_model, evaluate

    cfg = _corpus_config(tmp_path)
    model = build_model(cfg, seed=2)
    counts = []
    for staged in (False, True):
        before = launch_counts()
        res = evaluate(cfg, model, device_features=staged)
        counts.append((res, {k: launch_counts()[k] - before[k]
                             for k in before}))
    assert counts[0][0] == counts[1][0]
    assert counts[0][1] == counts[1][1] and counts[0][1]["fused_stem"] == 2
    assert all(np.isfinite(v) for v in counts[0][0].values())


def test_glove_train_on_the_card_keeps_the_embedding(dev, tmp_path):
    from drn_tpu_torch.data.pipeline import build_vocab
    from drn_tpu_torch.evaluate import build_model
    from drn_tpu_torch.train import train

    cfg = _corpus_config(tmp_path, glove=True)
    vocab = build_vocab(cfg.data, cfg.model)
    before = launch_counts()
    model = train(cfg, max_steps=2, device_features=True)
    assert launch_counts()["fused_fusion_block_bwd"] > \
        before["fused_fusion_block_bwd"]
    sd = model.state_dict()
    assert sd["embed.weight"].device.type == "cuda"
    assert torch.equal(sd["embed.weight"].cpu(),
                       torch.from_numpy(vocab.embeddings))
    init = build_model(cfg, device="cpu", seed=cfg.train.seed,
                       pretrained_embeddings=vocab.embeddings).state_dict()
    assert not torch.equal(sd["stem.conv.weight"].cpu(),
                           init["stem.conv.weight"])


# --- the kernels as custom ops, the exported step, the server -----------


def _direct(name, args):
    """`name`'s kernel launched straight through its C entry point, with
    the wrapper's plan, bypassing the custom op."""
    from drn_tpu_torch.ops.cuda import _build
    from drn_tpu_torch.ops.cuda.conv_block import same_padding, stream_of

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if name == "conv_ln_relu":
        x, w, b, s, o, stride, use_norm, use_act = args
        (bsz, t, cin), (k, _, cout) = x.shape, w.shape
        out_t, left, _ = same_padding(t, k, stride)
        out = torch.empty((bsz, out_t, cout), dtype=torch.bfloat16,
                          device=x.device)
        fn = _build.entry("conv_block", "drn_conv_ln_relu", 6, 12)
        rc = fn(*[a.data_ptr() for a in (x, w, b, s, o, out)], bsz, t, cin,
                cout, k, stride, out_t, left, int(use_norm), int(use_act),
                *conv_plan(bsz * out_t, cout, sms), stream_of(x))
    elif name == "fused_stem":
        x, si, bi, w, b, s, o = args[:7]
        (bsz, t, cin), (k, _, cout) = x.shape, w.shape
        stats = torch.empty((bsz * t, 2), dtype=torch.float32,
                            device=x.device)
        out = torch.empty((bsz, t, cout), dtype=torch.bfloat16,
                          device=x.device)
        fn = _build.entry("stem", "drn_fused_stem", 9, 13)
        rc = fn(*[a.data_ptr() for a in (x, si, bi, w, b, s, o, stats, out)],
                bsz, t, cin, cout, k, 1, 1,
                *stem_plan(bsz * t, cin, cout, k, sms), stream_of(x))
    else:  # fused_fusion_block / fused_fusion
        v, q, w = args[:3]
        (bsz, t, d), (k, _, dout) = v.shape, w.shape
        out = torch.empty((bsz, t, dout), dtype=torch.bfloat16,
                          device=v.device)
        ptrs = [a.data_ptr() for a in (*args, out)]
        fn = _build.entry("fused_fusion", "drn_" + name, len(ptrs), 7)
        rc = fn(*ptrs, bsz, t, d, dout, k, *conv_plan(bsz * t, dout, sms),
                stream_of(v))
    assert rc == 0
    return out


def test_custom_ops_equal_their_direct_launches(dev):
    """Each kernel through its custom op (the wrapper) and through its
    autograd Function gives its direct launch's output bit for bit; the
    Function's backward recomputes through an op (its launches count):
    with LayerNorm, the kernel's backward op."""
    from drn_tpu_torch.ops.cuda import fused_fusion as ff

    x, v = _randn(dev, 3, 57, 128), _randn(dev, 3, 64, 512, seed=8)
    q = _randn(dev, 3, 512, scale=0.5, seed=5)
    w = _randn(dev, 3, 128, 512, scale=0.05, seed=4)
    wf = _randn(dev, 3, 512, 512, scale=0.03, seed=6)
    epi = _epilogue(dev, 512)
    xs = _randn(dev, 3, 57, 128, dtype=torch.float32, seed=7)
    si, bi = 1.0 + 0.1 * xs[0, :1, :].flatten(), 0.1 * xs[1, :1, :].flatten()
    # name → (args, wrapper, Function, the launches of its backward)
    cases = {
        "conv_ln_relu": ((x, w, *epi, 2, True, True), conv_ln_relu,
                         ConvLnReluFn, {"conv_ln_relu_bwd": 1}),
        "fused_stem": ((xs, si, bi, w, *epi), fused_stem, FusedStemFn,
                       {"fused_stem": 1}),
        "fused_fusion_block": ((v, q, wf, *epi), fused_fusion_block,
                               FusedFusionBlockFn,
                               {"fused_fusion_block_bwd": 1,
                                "conv_ln_relu": 1}),
        "fused_fusion": ((v, q, wf, epi[0]), ff.fused_fusion, FusedFusionFn,
                         {"conv_ln_relu": 1}),
    }
    for name, (args, wrapper, fn, backward) in cases.items():
        want = _direct(name, args)
        with torch.no_grad():
            assert torch.equal(wrapper(*args), want), name
        leaves = [a.detach().clone().requires_grad_(a.is_floating_point())
                  if torch.is_tensor(a) else a for a in args]
        out = fn.apply(*leaves)
        assert torch.equal(out.detach(), want), name
        before = launch_counts()
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert {k: n - before[k] for k, n in launch_counts().items()
                if n != before[k]} == backward, name
        assert all(torch.isfinite(a.grad).all() for a in leaves
                   if torch.is_tensor(a) and a.grad is not None), name


def test_exported_cuda_step_equals_the_live_step(dev, tmp_path):
    from collections import Counter

    from drn_tpu_torch import export
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model
    from drn_tpu_torch.probes.export_roundtrip import make_batch

    cfg = get_config("synthetic_tiny")
    model = build_model(cfg, seed=3)
    ep, sidecar = export.export_eval_step(cfg, model, 8)
    nodes = Counter(str(n.target) for n in ep.graph.nodes
                    if str(n.target).startswith("drn_tpu_torch."))
    m = cfg.model
    assert nodes == {
        "drn_tpu_torch.fused_stem.default": 1,
        "drn_tpu_torch.fused_fusion_block.default": m.num_levels,
        "drn_tpu_torch.conv_ln_relu.default": 3 * m.num_levels
        + 2 * m.head_tower_layers + m.iou_head_layers,
        "drn_tpu_torch.nms_sweep.default": 1}
    path = str(tmp_path / "drn.pt2")
    export.save_exported(ep, sidecar, path)
    call, sidecar = export.load_exported(path)
    assert sidecar["device"].startswith("cuda")
    batch = {k: torch.as_tensor(a, device=dev) for k, a in make_batch(
        export.batch_spec(cfg, 8), m.vocab_size).items()}
    for seed in (3, 4):
        live = build_model(cfg, seed=seed)
        want = export.EvalStep(cfg, live)(**batch)
        before = launch_counts()
        got = call(live.state_dict(), batch)
        after = launch_counts()
        assert [after[k] - before[k] for k in ("fused_stem", "nms_sweep")] \
            == [1, 1]
        for k in ("segments_seconds", "nms_keep", "scores", "n_valid"):
            assert torch.equal(got[k], want[k]), (seed, k)
        assert {k: v.item() for k, v in got["recall_counts"].items()} == \
            {k: v.item() for k, v in want["recall_counts"].items()}


def test_a_served_request_runs_on_the_batcher_thread(dev, monkeypatch):
    """The server's kernels launch from its batcher thread, and the answer
    equals `predict` on the padded batch the service builds."""
    import json
    import threading
    import urllib.request

    from drn_tpu_torch import serve
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import predict
    from drn_tpu_torch.ops.cuda import conv_block, fused_fusion, stem

    service = serve.build_service(get_config("synthetic_tiny"), top=3)
    service.start()
    threads = []
    for mod in (conv_block, fused_fusion, stem):
        real = mod.stream_of
        monkeypatch.setattr(mod, "stream_of", lambda t, real=real: (
            threads.append(threading.get_ident()), real(t))[1])
    httpd = serve.GroundingHTTPServer(("127.0.0.1", 0),
                                      serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    payload = {"query": "a person opens the door", "duration": 20.0,
               "features": np.random.default_rng(0).standard_normal(
                   (40, 128)).tolist()}
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/ground",
            data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        assert threads and set(threads) == {service._thread.ident}
    finally:
        httpd.shutdown()
        service.stop()
    segs, keep, scores = predict(service.cfg, service.model,
                                 service.padded_batch(
                                     [service.prepare(payload)]))
    kept = [j for j in range(segs.shape[1]) if keep[0, j]][:3]
    assert got == {"segments": [[float(segs[0, j, 0]), float(segs[0, j, 1])]
                                for j in kept],
                   "scores": [float(scores[0, j]) for j in kept]}


# --- training at production width, and the worker-fed step -----------------


def _flagship_synthetic(num_clips, batch_size, **model):
    """charades_c3d (hidden 512, the kernels' width) on the synthetic
    fixture at F=1024, stage 2 trained jointly, as tests/
    test_train_overfit.py sets it up."""
    from drn_tpu_torch.config import get_config

    cfg = get_config("charades_c3d")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, feature_dim=1024, **model),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 num_clips=num_clips, batch_size=batch_size),
        train=dataclasses.replace(cfg.train, stage=2, stage2_iou_only=False))


def _overfit(dev, cfg, n, steps, key):
    from drn_tpu_torch.data.pipeline import BatchIterator
    from drn_tpu_torch.data.synthetic import SyntheticDataset
    from drn_tpu_torch.evaluate import build_model, to_device
    from drn_tpu_torch.train import make_optimizer, make_train_step

    ds = SyntheticDataset(cfg.data, cfg.model, num_examples=n)
    batch = to_device(next(BatchIterator(ds, n, shuffle=False).epoch(0)), dev)
    model = build_model(cfg, seed=0).train()
    step = make_train_step(cfg, model, make_optimizer(cfg, 100, model))
    before = launch_counts()
    history = [float(step(batch)[key]) for _ in range(steps)]
    after = launch_counts()
    assert all(after[k] > before[k] for k in ("fused_stem", "conv_ln_relu",
                                              "fused_fusion_block",
                                              "conv_ln_relu_bwd",
                                              "fused_fusion_block_bwd"))
    return history


def test_regression_learns_at_flagship_width(dev):
    """Twin of tests/test_train_overfit.py's: through the kernels forward
    and backward at width 512, regression keeps learning long after the
    first steps (a frozen decode would hold mean_pos_iou still)."""
    history = _overfit(dev, _flagship_synthetic(32, 4), 4, 30,
                       "mean_pos_iou")
    assert history[-1] > history[2] + 0.1, history[::5]
    assert history[-1] > 0.45, history[-1]


def test_stage2_iou_head_learns_under_fold_at_flagship_width(dev):
    """Twin of tests/test_train_overfit.py's: the stage-2 IoU loss halves
    at width 512 on a 256-clip grid with the IoU head's mix fold forced
    on (iou_fold_mix_min_locations=0)."""
    history = _overfit(dev, _flagship_synthetic(
        256, 2, iou_fold_mix_min_locations=0), 2, 14, "iou_loss")
    assert np.isfinite(history).all(), history
    assert history[-1] < 0.5 * history[0], history


def test_worker_fed_train_step_equals_the_in_process_one(dev):
    """The batch from 2 worker processes, pinned, equals the in-process
    batch, and the train step on it equals the step on that batch."""
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import (BatchIterator,
                                             WorkerBatchIterator,
                                             make_dataset)
    from drn_tpu_torch.evaluate import build_model, to_device
    from drn_tpu_torch.train import loss_and_grads

    cfg = get_config("synthetic_tiny")
    ds = make_dataset(cfg.data, cfg.model)
    want = next(BatchIterator(ds, 8, shuffle=True, seed=4).epoch(2))
    it = WorkerBatchIterator(ds, 8, shuffle=True, seed=4, num_workers=2,
                             pin_memory=True)
    try:
        got = next(it.epoch(2))
    finally:
        it.close()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.from_numpy(got[k]).is_pinned(), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = build_model(cfg, seed=1).train()
    runs = []
    for batch in (want, got):
        loss = loss_and_grads(cfg, model, to_device(batch, dev))["loss"]
        runs.append((loss.item(), {k: p.grad.clone() for k, p in
                                   model.named_parameters()
                                   if p.grad is not None}))
    assert runs[0][0] == runs[1][0]
    for k, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], g, rtol=1e-5, atol=1e-7,
                                   msg=k)


# --- the recipe probes: chip_smoke's `recipe` gates ----------------------


def test_recipe_demo_gates_on_the_card(dev, tmp_path):
    """tests/test_recipe.py's gates through the kernels (synthetic_recipe,
    1 epoch a stage, seed 0), the IoU-only stage 2 bit-identical outside
    the IoU head, and the backward kernels in stage 1's backward."""
    from drn_tpu_torch.probes import recipe_demo

    info = {}
    results = recipe_demo.run_demo("synthetic_recipe", 1, 1, str(tmp_path),
                                   seed=0, device=dev, run=info)
    assert recipe_demo.gate_failures(results, info) == []
    for k in ("conv_ln_relu_bwd", "fused_fusion_block_bwd"):
        assert info["launches"]["stage1_train"][k] > 0
    for k in ("fused_stem", "fused_fusion_block", "conv_ln_relu"):
        assert info["launches"]["stage1_train"][k] > 0
        assert info["launches"]["stage2_eval"][k] > 0


def test_atscale_synthetic_checks_on_the_card(dev, capsys):
    """charades_c3d's width at the script's defaults: the freeze and the
    lift checks raise when they fail."""
    from drn_tpu_torch.probes import atscale_synthetic

    assert atscale_synthetic.main([]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "ATSCALE OK"


def test_int8_probe_gates_on_the_card(dev, capsys):
    """The stem-shaped product: the int8 accumulators equal to float64's,
    every row (FP8 included) within its type's error bound."""
    import json

    from drn_tpu_torch.probes import int8_probe

    assert int8_probe.main(["--iters", "16"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 8 and int8_probe.gate_failures(rows) == []
    assert rows[1]["row"] == "int8" and rows[1]["acc_equal"]
