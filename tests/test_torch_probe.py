"""The port of the measurement probe's block (`pallas_block`, `xla_block`)
against the JAX probe's own functions, on the same seeded numpy inputs.

The JAX probe's `pallas_call` takes no `interpret=` argument, so it runs
here unedited under `pltpu.force_tpu_interpret_mode()`; the port's
wrapper runs its plain version on these CPU tensors.

Tolerances: fp32 1e-4 (summation order only). bf16: both sides take bf16
inputs, accumulate in fp32 and round the output to bf16 once, so they may
differ by a rounding flip: 1/128 absolute + 1/128 relative (two bf16 ulps
at |y| ~ 1). Kernel against `xla_block` in bf16 (odd K, where both pad as
SAME): `xla_block` rounds the conv output to bf16 before a bf16 bias add,
so a value may move by a few ulps of the conv output's scale before the
LayerNorm: 1/16 absolute + 1/32 relative (the bf16 bar of
tests/test_torch_kernels.py against the XLA references).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from drn_tpu_torch.ops.cuda import launch_counts, pallas_block, xla_block
from drn_tpu_torch.probes import pallas_block_probe as probe
from scripts.pallas_block_probe import pallas_block as jax_pallas_block
from scripts.pallas_block_probe import xla_block as jax_xla_block

from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1 / 128, 1 / 128)}
D = 128


def _inputs(b, t, k, seed=0):
    """v, q, w, b, scale, offset as numpy fp32, scaled as the probe's."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(rng.normal(size=(b, t, D))), f32(rng.normal(size=(b, D))),
            f32(rng.normal(size=(k, D, D)) * 0.05),
            f32(rng.normal(size=(D,)) * 0.1),
            f32(rng.normal(size=(D,)) * 0.2 + 1.0),
            f32(rng.normal(size=(D,)) * 0.1))


def _both(arrays, dtype):
    """(JAX args, port args): v, q, w, b in `dtype`, scale/offset fp32."""
    jdt, tdt = DTYPES[dtype][:2]
    j = [jnp.asarray(a, jdt) for a in arrays[:4]] + [
        jnp.asarray(a, jnp.float32) for a in arrays[4:]]
    t = [torch.from_numpy(a).to(tdt) for a in arrays[:4]] + [
        torch.from_numpy(a) for a in arrays[4:]]
    return j, t


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,k,bb,eps", [
    (16, 16, 3, 8, 1e-6),    # the probe's K, both batch blocks it runs
    (16, 16, 3, 16, 1e-6),
    (16, 13, 2, 8, 1e-6),    # even K: K // 2 rows of left padding
    (16, 16, 4, 16, 1e-3),   # even K, a non-default eps
    (16, 13, 3, 8, 1e-3),    # ragged T, a non-default eps
    (16, 16, 1, 8, 1e-6),    # K = 1: no padding
    (16, 13, 5, 16, 1e-3),   # K = 5: two rows on each side
])
def test_pallas_block_matches_the_jax_probe(dtype, b, t, k, bb, eps):
    atol, rtol = DTYPES[dtype][2:]
    jargs, targs = _both(_inputs(b, t, k), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pallas_block(*jargs, eps=eps, bb=bb)
    before = launch_counts()
    got = pallas_block(*targs, eps=eps)
    assert launch_counts() == before  # a CPU tensor launches no kernel
    assert got.dtype == targs[0].dtype and tuple(got.shape) == want.shape
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,eps", [(3, 1e-6), (2, 1e-3)])
def test_xla_block_matches_the_jax_probe(dtype, k, eps):
    """The probe's comparison, XLA SAME padding (left (K-1)//2) and the
    bias added in the input dtype after the conv's rounding."""
    atol, rtol = DTYPES[dtype][2:]
    jargs, targs = _both(_inputs(16, 13, k, seed=1), dtype)
    want = jax_xla_block(*jargs, eps=eps)
    got = xla_block(*targs, eps=eps)
    assert got.dtype == targs[0].dtype
    _close(got, want, atol, rtol)


def test_kernel_against_xla_block_in_bf16():
    """What the probe prints first, at a small size: the block against
    the probe's comparison differs by bf16 roundings only."""
    _, targs = _both(_inputs(16, 16, 3, seed=2), "bfloat16")
    _close(pallas_block(*targs), xla_block(*targs).float().numpy(),
           1 / 16, 1 / 32)


def test_every_batch_row_is_computed():
    """B = 12 with the probe's bb = 8: the JAX probe's grid (B // bb = 1
    step) never writes rows 8..11; the port computes every row, each as
    it would alone."""
    jargs, targs = _both(_inputs(12, 16, 3, seed=3), "float32")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_pallas_block(*jargs, bb=8))
    got = pallas_block(*targs)
    _close(got[:8], want[:8], 1e-4, 1e-4)
    tail = pallas_block(targs[0][8:], targs[1][8:], *targs[2:])
    torch.testing.assert_close(got[8:], tail, atol=1e-6, rtol=1e-6)


def test_probe_inputs_are_the_jax_probes():
    """`make_inputs` draws what the JAX probe's main() draws, in its order
    and scales (`scripts/pallas_block_probe.py:117-123`)."""
    b, t, d, k = 4, 8, 64, 3
    rng = np.random.default_rng(0)
    want = (jnp.asarray(rng.normal(size=(b, t, d)), jnp.bfloat16),
            jnp.asarray(rng.normal(size=(b, d)), jnp.bfloat16),
            jnp.asarray(rng.normal(size=(k, d, d)) * 0.05, jnp.bfloat16),
            jnp.asarray(rng.normal(size=(d,)) * 0.1, jnp.bfloat16),
            jnp.asarray(rng.normal(size=(d,)) * 0.2 + 1.0, jnp.float32),
            jnp.asarray(rng.normal(size=(d,)) * 0.1, jnp.float32))
    got = probe.make_inputs(b, t, d, k, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_library_yardstick_computes_the_block():
    """The probe's cuDNN yardstick (F.conv1d + F.layer_norm + ReLU) is the
    same block, odd and even K, within bf16 rounding."""
    for k in (3, 4):
        args = probe.make_inputs(4, 16, 64, k, "cpu", seed=k)
        _close(probe.library_block(*args)(),
               pallas_block(*args).float().numpy(), 1 / 16, 1 / 32)


def test_probe_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
    with pytest.raises(RuntimeError, match="runs on cuda"):
        probe.run("cpu")
