"""The port's plain kernel versions (what its wrappers run on a CPU tensor)
against the JAX package's Pallas kernels in interpret mode and their XLA
references, on the same seeded numpy inputs.

Tolerances: fp32 1e-4 (summation order only). bf16: both sides take bf16
inputs, accumulate in fp32 and round the output to bf16 once, so they may
differ by a rounding flip: 1/128 absolute + 1/128 relative (two bf16 ulps
at |y| ~ 1). Against the XLA reference in bf16 the conv output is also
rounded to bf16 before a bf16 bias add on the JAX side: 1/16 absolute
+ 1/32 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_tpu.ops.pallas import conv_block as pl_conv
from drn_tpu.ops.pallas import fused_fusion as pl_fusion
from drn_tpu.ops.pallas import stem as pl_stem
from drn_tpu_torch.ops.cuda import (conv_ln_relu, fused_fusion_block,
                                    fused_stem, launch_counts)
from drn_tpu_torch.ops.cuda.conv_block import same_padding

from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-4, 1e-4, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1 / 128, 1 / 128,
                       1 / 16, 1 / 32)}


def _np_inputs(b=4, t=32, cin=128, cout=128, k=3, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        x=f32(rng.normal(size=(b, t, cin))),
        w=f32(rng.normal(size=(k, cin, cout)) * 0.05),
        b=f32(rng.normal(size=(cout,)) * 0.1),
        scale=f32(rng.normal(size=(cout,)) * 0.2 + 1.0),
        offset=f32(rng.normal(size=(cout,)) * 0.1),
    )


def _jax(a, dt):
    return jnp.asarray(a, dt)


def _torch(a, dt):
    return torch.from_numpy(a).to(dt)


def _bias(a, dt):
    """The bias as the kernel takes it: rounded to the compute dtype, fp32."""
    return torch.from_numpy(a).to(dt).float()


def _close(got, want, atol, rtol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,stride,t,use_norm,use_act", [
    (3, 1, 32, True, True),
    (3, 2, 32, True, True),
    (1, 1, 32, True, False),   # the FPN laterals
    (3, 1, 57, True, True),    # ragged T (the heads' gap concat is T=114)
    (3, 2, 57, False, True),
    (1, 2, 32, False, False),
])
def test_conv_ln_relu_plain_matches_pallas(dtype, k, stride, t, use_norm,
                                           use_act):
    jdt, tdt, atol, rtol, xatol, xrtol = DTYPES[dtype]
    p = _np_inputs(t=t, k=k)
    args_j = (_jax(p["x"], jdt), _jax(p["w"], jdt), _jax(p["b"], jdt),
              _jax(p["scale"], jnp.float32), _jax(p["offset"], jnp.float32))
    want = pl_conv.conv_ln_relu(*args_j, stride, use_norm, use_act)
    ref = pl_conv.xla_reference(*args_j, stride=stride, use_norm=use_norm,
                                use_act=use_act)
    before = launch_counts()
    got = conv_ln_relu(_torch(p["x"], tdt), _torch(p["w"], tdt),
                       _bias(p["b"], tdt), _torch(p["scale"], torch.float32),
                       _torch(p["offset"], torch.float32), stride, use_norm,
                       use_act)
    assert launch_counts() == before  # a CPU tensor launches no kernel
    assert got.dtype == tdt
    assert tuple(got.shape) == tuple(want.shape) == (
        4, same_padding(t, k, stride)[0], 128)
    _close(got, want, atol, rtol)
    _close(got, ref, xatol, xrtol)


# (T, K, D) of the fusion kernels' plain versions against the Pallas
# kernels: the flagship's K=3 at an even and a ragged T, K=1 and K=5 (the
# JAX kernels take any odd K), and a D that is not a multiple of 8 (the
# CUDA kernels stage such rows channel by channel). The first two keep
# their earlier ids.
FUSION_CASES = [pytest.param(32, 3, 128, id="32"),
                pytest.param(57, 3, 128, id="57"),
                pytest.param(32, 1, 128, id="32-k1"),
                pytest.param(21, 5, 128, id="21-k5"),
                pytest.param(32, 3, 20, id="32-d20")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,k,d", FUSION_CASES)
def test_fused_fusion_block_plain_matches_pallas(dtype, t, k, d):
    jdt, tdt, atol, rtol, xatol, xrtol = DTYPES[dtype]
    p = _np_inputs(t=t, cin=d, cout=d, k=k)
    q = np.random.default_rng(1).normal(size=(4, d)).astype(np.float32)
    args_j = (_jax(p["x"], jdt), _jax(q, jdt), _jax(p["w"], jdt),
              _jax(p["b"], jdt), _jax(p["scale"], jnp.float32),
              _jax(p["offset"], jnp.float32))
    want = pl_fusion.fused_fusion_block(*args_j)
    ref = pl_fusion.xla_block_reference(*args_j)
    got = fused_fusion_block(_torch(p["x"], tdt), _torch(q, tdt),
                             _torch(p["w"], tdt), _bias(p["b"], tdt),
                             _torch(p["scale"], torch.float32),
                             _torch(p["offset"], torch.float32))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol, rtol)
    _close(got, ref, xatol, xrtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_stem_plain_matches_pallas(dtype):
    jdt, tdt, atol, rtol, xatol, xrtol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.normal(size=(4, 16, 128)) * 3.0 + 0.5)
    i_s = f32(rng.normal(size=(128,)) * 0.2 + 1.0)
    i_b = f32(rng.normal(size=(128,)) * 0.1)
    w = f32(rng.normal(size=(3, 128, 128)) * 0.05)
    b = f32(rng.normal(size=(128,)) * 0.1)
    o_s = f32(rng.normal(size=(128,)) * 0.2 + 1.0)
    o_b = f32(rng.normal(size=(128,)) * 0.1)
    j = lambda a: jnp.asarray(a, jnp.float32)
    want = pl_stem.fused_stem(j(x), j(i_s), j(i_b), j(w), j(b), j(o_s),
                              j(o_b), jdt)
    ref = pl_stem.xla_reference(j(x), j(i_s), j(i_b), j(w), j(b), j(o_s),
                                j(o_b), cdtype=jdt)
    t = torch.from_numpy
    got = fused_stem(t(x), t(i_s), t(i_b), t(w).to(tdt), _bias(b, tdt),
                     t(o_s), t(o_b), tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol, rtol)
    _close(got, ref, xatol, xrtol)


@pytest.mark.parametrize("t,k,stride", [(64, 3, 2), (57, 3, 2), (114, 3, 1),
                                        (112, 1, 1), (16, 3, 2)])
def test_same_padding_matches_xla(t, k, stride):
    """XLA SAME is asymmetric for stride 2 (left 0 / right 1 at k=3, even
    T): the port's padding gives XLA's output length and alignment."""
    import jax

    x = np.arange(t, dtype=np.float32)[None, :, None]
    w = np.zeros((k, 1, 1), np.float32)
    w[0] = 1.0  # picks the first tap: reveals the left padding
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))
    out_t, left, right = same_padding(t, k, stride)
    xp = np.pad(x[0, :, 0], (left, right))
    np.testing.assert_array_equal(np.asarray(want)[0, :, 0],
                                  xp[0:(out_t - 1) * stride + 1:stride])


# --- fused_fusion and the gradients of the four kernels ------------------
#
# Gradients: the port's autograd Functions (ops/cuda/autograd.py) on CPU
# tensors, where their wrappers run the plain versions, against jax.vjp of
# the Pallas functions, whose custom VJPs run unchanged on the CPU. fp32:
# 1e-4 (summation order only). bf16: the cotangent is rounded to bf16 where
# each side's forward rounds, but the two sides round their products and
# sums at other places, so each gradient is held by its relative L2 error,
# ≤ 5e-2: the JAX side sums a bf16 bias's gradient in bf16 over the B·T
# rows (about √n·2^-9 relative, 2% at n = 116 rows), the port in fp32.

from drn_tpu_torch.ops.cuda.autograd import (ConvLnReluFn,  # noqa: E402
                                             FusedFusionBlockFn,
                                             FusedFusionFn, FusedStemFn)
from drn_tpu_torch.ops.cuda.fused_fusion import (  # noqa: E402
    fused_fusion, fused_fusion_backward)

GRAD_REL_BF16 = 5e-2


def _grad_close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= GRAD_REL_BF16, err


def _port_grads(fn, args, g):
    """Run autograd Function `fn` on `args` (tensors get requires_grad)
    and back-propagate `g`: (output, grads of the tensor args)."""
    leaves = [a.detach().clone().requires_grad_() if
              isinstance(a, torch.Tensor) else a for a in args]
    out = fn.apply(*leaves)
    out.backward(g)
    return out, [a.grad for a in leaves if isinstance(a, torch.Tensor)]


def _fusion_inputs(t, dtype, seed=1, k=3, d=128):
    jdt, tdt = DTYPES[dtype][:2]
    p = _np_inputs(t=t, cin=d, cout=d, k=k)
    q = np.random.default_rng(seed).normal(size=(4, d)).astype(np.float32)
    g = np.random.default_rng(seed + 1).normal(size=(4, t, d)).astype(
        np.float32)
    jargs = (_jax(p["x"], jdt), _jax(q, jdt), _jax(p["w"], jdt),
             _jax(p["b"], jdt))
    targs = (_torch(p["x"], tdt), _torch(q, tdt), _torch(p["w"], tdt),
             _bias(p["b"], tdt))
    return p, jargs, targs, (_jax(g, jdt), _torch(g, tdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,k,d", FUSION_CASES)
def test_fused_fusion_plain_matches_pallas(dtype, t, k, d):
    _, atol, rtol, xatol, xrtol = DTYPES[dtype][1:]
    _, jargs, targs, _ = _fusion_inputs(t, dtype, k=k, d=d)
    want = pl_fusion.fused_fusion(*jargs)
    ref = pl_fusion.xla_reference(*jargs)
    before = launch_counts()
    got = fused_fusion(*targs)
    assert launch_counts() == before
    assert got.dtype == targs[0].dtype and tuple(got.shape) == want.shape
    _close(got, want, atol, rtol)
    _close(got, ref, xatol, xrtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_fusion_backward_matches_its_custom_vjp(dtype):
    """The port's `fused_fusion_backward` against the JAX package's
    hand-written `_bwd`, reached through jax.vjp of `fused_fusion`."""
    _, jargs, targs, (jg, tg) = _fusion_inputs(32, dtype)
    _, vjp = jax.vjp(pl_fusion.fused_fusion, *jargs)
    want = vjp(jg)
    got = fused_fusion_backward(tg, *targs[:3])
    for name, gt, wt, arg in zip(("dv", "dq", "dw", "db"), got, want,
                                 (*targs[:3], tg)):
        assert gt.dtype == arg.dtype, name
        _grad_close(gt, wt, dtype)
    _, grads = _port_grads(FusedFusionFn, targs, tg)
    for gt, wt in zip(grads, want):
        _grad_close(gt, wt, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,stride,t,use_norm,use_act", [
    (3, 1, 32, True, True),
    (3, 2, 32, True, True),    # the strided level blocks
    (3, 2, 57, True, True),    # odd T: XLA's SAME pads left 1, right 1
    (1, 1, 32, True, False),   # the FPN laterals
    (1, 2, 32, False, True),
])
def test_conv_ln_relu_gradients_match_jax(dtype, k, stride, t, use_norm,
                                          use_act):
    jdt, tdt = DTYPES[dtype][:2]
    p = _np_inputs(t=t, k=k)
    out_t = same_padding(t, k, stride)[0]
    g = np.random.default_rng(7).normal(size=(4, out_t, 128)).astype(
        np.float32)
    jargs = (_jax(p["x"], jdt), _jax(p["w"], jdt), _jax(p["b"], jdt),
             _jax(p["scale"], jnp.float32), _jax(p["offset"], jnp.float32))
    _, vjp = jax.vjp(lambda *a: pl_conv.conv_ln_relu(*a, stride, use_norm,
                                                     use_act), *jargs)
    want = vjp(_jax(g, jdt))
    targs = (_torch(p["x"], tdt), _torch(p["w"], tdt), _bias(p["b"], tdt),
             _torch(p["scale"], torch.float32),
             _torch(p["offset"], torch.float32), stride, use_norm, use_act)
    _, grads = _port_grads(ConvLnReluFn, targs, _torch(g, tdt))
    for i, (gt, wt) in enumerate(zip(grads, want)):
        if not use_norm and i >= 3:  # scale and offset are not used
            assert gt is None or not gt.any()
            continue
        _grad_close(gt, wt, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_fusion_block_gradients_match_jax(dtype):
    jdt, tdt = DTYPES[dtype][:2]
    p, jargs, targs, (jg, tg) = _fusion_inputs(32, dtype)
    epi = (p["scale"], p["offset"])
    _, vjp = jax.vjp(pl_fusion.fused_fusion_block, *jargs,
                     *(_jax(a, jnp.float32) for a in epi))
    want = vjp(jg)
    _, grads = _port_grads(FusedFusionBlockFn,
                           (*targs, *(_torch(a, torch.float32) for a in epi)),
                           tg)
    for gt, wt in zip(grads, want):
        _grad_close(gt, wt, dtype)


# The backward kernels' closed-form LayerNorm+ReLU VJP (their plain
# versions, with the kernels' arithmetic) against autograd through
# `layer_norm` (`epilogue_vjp`) at the same fp32 conv + b. A constant row
# (every input of a video zero, the bias 0.1 in every channel) makes the
# fast variance E[x²] − E[x]² come out below 0 in fp32, where it clamps and
# its gradient stops. Both sides see one fp32 `pre`, so the fp32 outputs
# differ by summation order only; dpre in bf16 by its one rounding.

from drn_tpu_torch.ops.cuda.autograd import epilogue_vjp  # noqa: E402
from drn_tpu_torch.ops.cuda.conv_block import (  # noqa: E402
    conv_ln_relu_bwd_reference, conv_taps)
from drn_tpu_torch.ops.cuda.fused_fusion import (  # noqa: E402
    fused_fusion_block_bwd_reference)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("constant_row", [False, True])
@pytest.mark.parametrize("kind,k,stride,use_act", [
    ("conv", 3, 1, True), ("conv", 3, 2, True), ("conv", 1, 1, False),
    ("fusion", 3, 1, True)])
def test_ln_relu_backward_closed_form_matches_autograd(dtype, constant_row,
                                                       kind, k, stride,
                                                       use_act):
    tdt = DTYPES[dtype][1]
    p = _np_inputs(t=32, k=k)
    b = _bias(p["b"], tdt)
    if constant_row:
        p["x"][1] = 0.0
        b = torch.full_like(b, 0.1)
    rng = np.random.default_rng(11)
    out_t, left, _ = same_padding(32, k, stride)
    x, w = _torch(p["x"], tdt), _torch(p["w"], tdt)
    scale = _torch(p["scale"], torch.float32)
    offset = _torch(p["offset"], torch.float32)
    g = _torch(rng.normal(size=(4, out_t, 128)).astype(np.float32), tdt)
    if kind == "fusion":
        q = _torch(rng.normal(size=(4, 128)).astype(np.float32), tdt)
        got = fused_fusion_block_bwd_reference(x, q, w, b, scale, offset, g)
        x = x * q[:, None, :]
    else:
        got = conv_ln_relu_bwd_reference(x, w, b, scale, offset, g, stride,
                                         use_act)
    pre = conv_taps(x, w, out_t, left, stride) + b
    mean = pre.mean(-1)
    clamped = (pre * pre).mean(-1) - mean * mean < 0
    assert bool(clamped[1].all()) == constant_row
    dpre, ds, do = epilogue_vjp(pre, scale, offset, g, True, use_act)
    assert got[0].dtype == tdt and got[0].shape == dpre.shape
    assert all(t.dtype == torch.float32 for t in got[1:])
    for gt, wt in zip(got, (dpre, ds, do, dpre.sum((0, 1)))):
        err = ((gt.float() - wt).norm() / wt.norm()).item()
        assert err <= (1e-5 if gt.dtype == torch.float32 else 2 ** -8), err


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_stem_gradients_match_jax(dtype):
    jdt, tdt = DTYPES[dtype][:2]
    rng = np.random.default_rng(3)
    f32 = lambda a: np.asarray(a, np.float32)
    cin = 100  # any width: activitynet_c3d's features are 500 wide
    x = f32(rng.normal(size=(4, 16, cin)) * 3.0 + 0.5)
    args = [x, f32(rng.normal(size=(cin,)) * 0.2 + 1.0),
            f32(rng.normal(size=(cin,)) * 0.1),
            f32(rng.normal(size=(3, cin, 128)) * 0.05),
            f32(rng.normal(size=(128,)) * 0.1),
            f32(rng.normal(size=(128,)) * 0.2 + 1.0),
            f32(rng.normal(size=(128,)) * 0.1)]
    g = f32(rng.normal(size=(4, 16, 128)))
    _, vjp = jax.vjp(lambda *a: pl_stem.fused_stem(*a, jdt),
                     *(jnp.asarray(a) for a in args))
    want = vjp(_jax(g, jdt))
    t = torch.from_numpy
    targs = [t(a) for a in args]
    targs[3] = targs[3].to(tdt)
    targs[4] = _bias(args[4], tdt)
    _, grads = _port_grads(FusedStemFn, (*targs, tdt), _torch(g, tdt))
    for gt, wt in zip(grads, want):
        _grad_close(gt, wt, dtype)
