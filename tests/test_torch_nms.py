"""The port's NMS on the CPU (drn_tpu_torch/ops/nms.py): its sweep's plain
version (ops/cuda/nms_sweep.py), which the CUDA kernel equals bit for bit
(tests/test_torch_cuda.py), against the JAX package's on the same inputs;
the sweep's counters, its custom op off the CPU, and its block size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_tpu.ops import batched_temporal_nms
from drn_tpu_torch.ops.cuda import launch_counts
from drn_tpu_torch.ops.cuda import nms_sweep as port_sweep
from drn_tpu_torch.ops.cuda.nms_sweep import MAX_K, sweep_threads
from drn_tpu_torch.ops.nms import (
    batched_temporal_nms as port_batched_temporal_nms)
from drn_tpu_torch.probes.nms_probe import SWEEP_KINDS, sweep_inputs

from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kind", SWEEP_KINDS)
@pytest.mark.parametrize("b,k", [(3, 1), (4, 33), (2, 48), (2, 300)])
def test_port_nms_equals_this_packages(b, k, kind):
    """Order, keep mask and sorted segments equal exactly, at each
    threshold; scores with ties (the stable sort keeps input order) but on
    the chain, whose rank order is its input order."""
    rng = np.random.default_rng(k)
    for thresh in (0.3, 0.5, 0.7):
        segs = sweep_inputs(b, k, kind, thresh, seed=k)
        scores = (np.tile(np.arange(k, 0, -1), (b, 1)) if kind == "chain"
                  else rng.integers(0, 4, (b, k))).astype(np.float32)
        want = batched_temporal_nms(jnp.asarray(segs), jnp.asarray(scores),
                                    thresh)
        got = port_batched_temporal_nms(torch.from_numpy(segs),
                                        torch.from_numpy(scores), thresh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if kind == "chain":  # kept and suppressed alternate
            assert got[1].numpy().tolist() == [[j % 2 == 0 for j in
                                                range(k)]] * b


def test_port_nms_sweep_counts_its_candidates():
    """B·K candidates a call on the CPU, and no kernel launch."""
    segs = torch.from_numpy(sweep_inputs(3, 17, "grid"))
    before, cands = launch_counts(), port_sweep.candidates
    keep = port_sweep(segs, 0.5)
    assert port_sweep.candidates - cands == 3 * 17
    assert launch_counts() == before and keep.shape == (3, 17)
    port_batched_temporal_nms(segs, torch.zeros(3, 17), 0.5)
    assert port_sweep.candidates - cands == 2 * 3 * 17


def test_port_nms_sweep_off_the_cpu_reaches_its_custom_op():
    """A tensor off the CPU (here on the meta device, as export traces
    the CUDA step) goes to the custom op, whose fake function gives the
    keep mask's shape; K above MAX_K raises before it."""
    segs = torch.empty(2, 48, 2, device="meta")
    cands = port_sweep.candidates
    keep = port_sweep(segs, 0.5)
    assert (keep.shape, keep.dtype, keep.device.type) == (
        (2, 48), torch.bool, "meta")
    assert port_sweep.candidates == cands  # counted where the op runs
    with pytest.raises(ValueError, match="MAX_K"):
        port_sweep(torch.empty(1, MAX_K + 1, 2, device="meta"), 0.5)


def test_port_nms_sweep_threads_follow_k():
    """A thread a candidate in whole warps, at most 1024."""
    assert [sweep_threads(k) for k in (1, 31, 32, 33, 48, 2548, MAX_K)] == [
        32, 32, 32, 64, 64, 1024, 1024]
