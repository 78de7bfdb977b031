"""The port's sequence parallelism (the mesh's "time" axis) in process: each
time-split conv form of models/layers.py, run on two simulated blocks of
the clip axis, equals the whole conv (the plain versions, fp32), and the
stem's host slice (parallel/mesh.py::time_slice) likewise. The two-rank
run of the time axis, against the JAX package's time-sharded step and
evaluate, is in tests/test_torch_tensor_parallel.py.

A simulated block gets its halo rows as `collectives.halo` hands them
over: its neighbours' edge rows, zeros beyond the clip axis's ends; both
blocks together cover both ends. Tolerance 1e-5 (fp32: the same products
in the same order, the halo only moves rows).
"""

import numpy as np
import pytest
import torch

from drn_tpu_torch.config import get_config
from drn_tpu_torch.models.layers import time_window
from drn_tpu_torch.ops.cuda.conv_block import conv_ln_relu_reference
from drn_tpu_torch.ops.cuda.fused_fusion import fused_fusion_block_reference
from drn_tpu_torch.ops.cuda.stem import fused_stem_reference
from drn_tpu_torch.parallel.mesh import (Mesh, check_axes, time_block,
                                         time_slice)

BLOCKS = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread (the suite's workers share the
    cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _halo(x, r, left, right):
    """Block r of BLOCKS along dim 1 with its halo rows."""
    n = x.shape[1] // BLOCKS
    zeros = lambda k: x.new_zeros((x.shape[0], k, x.shape[2]))  # noqa: E731
    lo = x[:, r * n - left:r * n] if r > 0 else zeros(left)
    hi = x[:, (r + 1) * n:(r + 1) * n + right] if r + 1 < BLOCKS \
        else zeros(right)
    return torch.cat([lo, x[:, r * n:(r + 1) * n], hi], 1)


def _inputs(t, cin, cout, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return (r(3, t, cin), r(k, cin, cout) / np.sqrt(k * cin), r(cout),
            r(cout).abs() + 0.5, r(cout))


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (5, 1), (3, 2)])
def test_time_split_conv_is_the_whole_conv(k, stride):
    t = 16
    x, w, b, s, o = _inputs(t, 24, 32, k)
    want = conv_ln_relu_reference(x, w, b, s, o, stride)
    n = t // BLOCKS
    parts = []
    for r in range(BLOCKS):
        left, right, lo, hi = time_window(k, stride, n)
        ext = _halo(x, r, left, right)
        parts.append(conv_ln_relu_reference(ext, w, b, s, o, stride)
                     [:, lo:hi])
    got = torch.cat(parts, 1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_time_window_refuses_what_it_cannot_align():
    with pytest.raises(ValueError, match="no time-split form"):
        time_window(3, 2, 7)   # an odd block before a stride-2 level
    with pytest.raises(ValueError, match="no time-split form"):
        time_window(5, 2, 8)


def test_time_split_fusion_block_is_the_whole_block():
    """v ⊙ q keeps the zero halo rows zero: SAME padding at both ends."""
    t, d, k = 16, 32, 3
    v, w, b, s, o = _inputs(t, d, d, k, seed=1)
    q = torch.randn(3, d, generator=torch.Generator().manual_seed(2))
    want = fused_fusion_block_reference(v, q, w, b, s, o)
    left, right, lo, hi = time_window(k, 1, t // BLOCKS)
    got = torch.cat([fused_fusion_block_reference(
        _halo(v, r, left, right), q, w, b, s, o)[:, lo:hi]
        for r in range(BLOCKS)], 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_time_sliced_stem_is_the_whole_stem():
    """The host slices each block with one real row each side (none past
    the ends: the input LayerNorm would turn a zero row into its offset);
    the stem runs SAME on it and keeps the block's rows, as
    models/backbone.py does."""
    t, f, d = 16, 40, 32
    x, w, b, s, o = _inputs(t, f, d, 3, seed=3)
    in_s, in_b = torch.rand(f) + 0.5, torch.randn(f)
    want = fused_stem_reference(x, in_s, in_b, w, b, s, o, torch.float32)
    parts = []
    for r in range(BLOCKS):
        mesh = Mesh(rank=r, world=BLOCKS, local_rank=r, device=None,
                    group=None, flags=None, time_axis=BLOCKS, time_rank=r)
        rows = time_slice({"features": x.numpy(), "valid": None},
                          mesh)["features"]
        s0, e0 = time_block(t, mesh)
        assert rows.shape[1] == (e0 - s0) + (r > 0) + (r + 1 < BLOCKS)
        y = fused_stem_reference(torch.from_numpy(rows), in_s, in_b, w, b, s,
                                 o, torch.float32)
        lo = 1 if r > 0 else 0
        parts.append(y[:, lo:lo + e0 - s0])
    torch.testing.assert_close(torch.cat(parts, 1), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["synthetic_tiny", "charades_c3d",
                                  "tacos_c3d"])
def test_check_axes_takes_the_registry_grids_over_two_time_ranks(name):
    check_axes(1, 2, 4, get_config(name))
    check_axes(2, 2, 4, get_config(name))
