"""The port's FLOP count, sanitizers and timers (drn_tpu_torch/utils/) against
the JAX package's (drn_tpu/utils/).

FLOPs: the hand-computed 2×MAC counts of tests/test_flops.py; each kernel
wrapper's count on a CPU tensor (its plain version's products, seen by
FlopCounterMode) equal to what it reports where it launches its kernel;
the LSTM's gate products per step; and the port's `synthetic_tiny` forward
against the JAX package's count of its own, exactly, once the JAX count
is rid of `linear_time_sample`'s one-hot selection products: the JAX
package samples the IoU head's features with two matrix products (a TPU
choice), the port with a gather, which does no multiply-add.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.models.layers import linear_time_sample as jax_time_sample
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu.utils.flops import estimate_flops as jax_estimate_flops
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.models import DRN
from drn_tpu_torch.ops.cuda import (conv_ln_relu, fused_fusion_block,
                                    fused_stem, pallas_block)
from drn_tpu_torch.ops.cuda.conv_block import same_padding
from drn_tpu_torch.ops.cuda.fused_fusion import fused_fusion
from drn_tpu_torch.utils import flops
from drn_tpu_torch.utils.debug import (assert_finite_tree, check_metrics,
                                       nan_debug)
from drn_tpu_torch.utils.flops import estimate_flops
from drn_tpu_torch.utils.profiling import throughput, time_fn, trace

# --- FLOPs ---------------------------------------------------------------


def _loop_recurrence(xs):
    w = torch.zeros(32, 32)
    carry = torch.zeros(32)
    for x in xs:  # the JAX test's scan: one (32,) @ (32, 32) per step
        carry = carry @ w + x
    return carry


@pytest.mark.parametrize("fn,args,want", [
    (torch.matmul, ((8, 32), (32, 16)), 2 * 8 * 32 * 16),
    (torch.bmm, ((4, 8, 32), (4, 32, 16)), 2 * 4 * 8 * 32 * 16),
    # (B=2, Cin=8, T=16) * kernel (Cout=4, Cin=8, k=3), SAME padding.
    (lambda x, k: F.conv1d(x, k, padding="same"), ((2, 8, 16), (4, 8, 3)),
     2 * (2 * 16 * 4) * (3 * 8)),
    (_loop_recurrence, ((10, 32),), 10 * 2 * 32 * 32),
], ids=["matmul", "batched_matmul", "conv1d_same", "recurrence_per_step"])
def test_hand_computed_flops(fn, args, want):
    assert estimate_flops(fn, *(torch.zeros(s) for s in args)) == want


@pytest.mark.parametrize("layers,bidirectional,backward", [
    (1, False, False), (2, True, False), (2, True, True)])
def test_lstm_gate_products_per_step(layers, bidirectional, backward):
    """T steps × 2·B·(in + H)·4H per direction and layer, whatever route
    nn.LSTM takes (one fused op here); a backward pass adds the data and
    the weight gradients, the same products twice more."""
    b, t, i, h = 4, 7, 16, 8
    lstm = nn.LSTM(i, h, num_layers=layers, bidirectional=bidirectional,
                   batch_first=True)
    x = torch.randn(b, t, i, requires_grad=backward)
    dirs = 2 if bidirectional else 1
    want = sum(dirs * t * 2 * b * ((i if l == 0 else h * dirs) + h) * 4 * h
               for l in range(layers))
    if backward:
        got = estimate_flops(lambda: lstm(x)[0].sum().backward())
        want *= 3
    else:
        got = estimate_flops(lstm, x)
    assert got == want


def _bf(*shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0)
                       ).to(dtype)


def _epi(n):
    return _bf(n, dtype=torch.float32), 1 + _bf(n, dtype=torch.float32), \
        _bf(n, dtype=torch.float32)


@pytest.mark.parametrize("name", [
    "conv_k3_s1", "conv_k3_s2", "conv_k1", "fusion_block", "fusion",
    "stem", "pallas_block_k3", "pallas_block_k2"])
def test_kernel_wrappers_count_their_conv(name):
    """On a CPU tensor each wrapper's plain version is counted by the mode:
    2·B·T_out·Cin·Cout·K, what the wrapper reports where it launches its
    kernel (`flops.add_conv`), so the card's count and the CPU's agree."""
    b, t, cin, cout = 2, 13, 24, 64
    k, stride = {"conv_k3_s2": (3, 2), "conv_k1": (1, 1),
                 "pallas_block_k2": (2, 1)}.get(name, (3, 1))
    x, w = _bf(b, t, cin), _bf(k, cin, cout)
    if name.startswith("conv"):
        call = (conv_ln_relu, x, w, *_epi(cout), stride)
    elif name == "fusion_block":
        call = (fused_fusion_block, x, _bf(b, cin), w, *_epi(cout))
    elif name == "fusion":
        call = (fused_fusion, x, _bf(b, cin), w, _epi(cout)[0])
    elif name == "stem":
        call = (fused_stem, x.float(), *_epi(cin)[1:], w, *_epi(cout))
    else:
        call = (pallas_block, x, _bf(b, cin), w, _bf(cout), *_epi(cout)[1:])
    t_out = same_padding(t, k, stride)[0]
    want = 2 * b * t_out * cin * cout * k
    assert estimate_flops(*call) == want
    assert estimate_flops(flops.add_conv, b, t_out, cin, cout, k) == want


def test_add_conv_counts_only_inside_an_estimate():
    flops.add_conv(1, 2, 3, 4, 5)  # no estimate in progress: nothing
    assert estimate_flops(lambda: None) == 0
    inner = []
    outer = estimate_flops(lambda: inner.append(
        estimate_flops(flops.add_conv, 1, 2, 3, 4, 5)))
    assert outer == inner[0] == 2 * 1 * 2 * 3 * 4 * 5


def test_synthetic_tiny_forward_matches_jax_count():
    """The same forward, weights carried across by convert.py: the port's
    count equals the JAX package's less the IoU head's selection
    products (flat sampling over the level concat at synthetic_tiny)."""
    cfg = jax_get_config("synthetic_tiny")
    model = jax_build_model(cfg)
    params = jax_init_params(cfg, model, jax.random.key(0))
    b, t, l = 4, cfg.data.num_clips, cfg.data.max_query_len
    feats = np.zeros((b, t, cfg.model.feature_dim), np.float32)
    words = np.zeros((b, l), np.int32)
    mask = np.ones((b, l), bool)
    want = jax_estimate_flops(
        lambda p: model.apply(p, jnp.asarray(feats), jnp.asarray(words),
                              jnp.asarray(mask)), params)
    sizes = [t // 2 ** i for i in range(cfg.model.num_levels)]
    selection = jax_estimate_flops(
        jax_time_sample, jnp.zeros((b, sum(sizes), cfg.model.hidden_dim)),
        jnp.zeros((b, 3 * sum(sizes))))

    port = DRN(get_config("synthetic_tiny").model, base_len=t)
    port.load_state_dict(flax_params_to_state_dict(
        jax.device_get(params), cfg.model))
    with torch.no_grad():
        got = estimate_flops(port, torch.from_numpy(feats),
                             torch.from_numpy(words), torch.from_numpy(mask))
    assert 0 < selection < 0.2 * want
    assert got == want - selection, (got, want, selection)


# --- debug ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dict", "state_dict", "list"])
def test_assert_finite_tree_flags_bad_leaf(kind):
    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2), "n": 3}}
    bad = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, math.nan])}}
    if kind == "state_dict":
        lin = nn.Linear(2, 2)
        good = {k: v.clone() for k, v in lin.state_dict().items()}
        with torch.no_grad():
            lin.bias[0] = math.inf
        bad, leaf = lin.state_dict(), "['bias']"
    elif kind == "list":
        good = [np.ones(3), (torch.zeros(2), 1.5)]
        bad, leaf = [np.ones(3), (np.array([np.inf]), 1.5)], "[1][0]"
    else:
        leaf = "['b']['c']"
    assert_finite_tree(good)
    with pytest.raises(FloatingPointError, match="params") as err:
        assert_finite_tree(bad, "params")
    assert str(err.value) == f"non-finite values in params: {[leaf]}"


def test_check_metrics():
    check_metrics({"loss": torch.tensor(1.0), "n": 3}, step=1)
    with pytest.raises(FloatingPointError,
                       match=r"at step 2: \['loss'\]"):
        check_metrics({"loss": torch.tensor(math.inf), "ok": 0.5}, step=2)


def test_nan_debug_context():
    before = torch.is_anomaly_enabled()
    with nan_debug():
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()  # 0/0: the backward's NaN is caught
    assert torch.is_anomaly_enabled() == before


# --- profiling -----------------------------------------------------------


def test_time_fn_and_throughput_have_the_jax_keys():
    a = torch.randn(16, 16)
    stats = time_fn(torch.matmul, a, a, iters=3, warmup=1)
    assert set(stats) == {"mean_ms", "median_ms", "min_ms", "iters"}
    assert stats["iters"] == 3.0
    assert 0 < stats["min_ms"] <= stats["median_ms"]
    assert throughput(torch.matmul, a, a, items_per_call=16, iters=3) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(16, 16)
    with trace(str(tmp_path / "t")):
        torch.matmul(a, a)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
