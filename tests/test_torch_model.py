"""The PyTorch port against the JAX package, module by module and for the
whole eval step, on the same weights and the same seeded numpy inputs.

Weights: the JAX package's `DRN.init`, every leaf shifted by seeded noise
(so biases, LayerNorm offsets and the per-level distance scales are not
their trivial init values), bridged into the port with
`flax_params_to_state_dict`. JAX runs on the CPU through its XLA path, the
port on the CPU through the kernels' plain versions.

Tolerances: fp32 1e-4 (summation order only); NMS keep masks and R@n hit
counts exactly; the mIoU accumulator, a float sum of tIoUs, to 1e-4
relative. bf16: see `BF16_TOL`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from drn_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from drn_tpu.evaluate import make_eval_step as jax_make_eval_step
from drn_tpu.models.backbone import Backbone as JaxBackbone
from drn_tpu.models.fpn import TemporalFPN as JaxFPN
from drn_tpu.models.fusion import CrossModalFusion as JaxFusion
from drn_tpu.models.heads import GroundingHeads as JaxHeads
from drn_tpu.models.heads import IoUHead as JaxIoUHead
from drn_tpu.models.query_encoder import QueryEncoder as JaxQueryEncoder
from drn_tpu.ops.metrics import MIOU_KEY
from drn_tpu.parity.convert import torch_state_to_flax
from drn_tpu.parity.torch_model import TorchDRNParity
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import (flax_params_to_state_dict,
                                   load_torch_checkpoint)
from drn_tpu_torch.data.pipeline import BatchIterator
from drn_tpu_torch.data.synthetic import SyntheticDataset
from drn_tpu_torch.evaluate import make_eval_step, to_device
from drn_tpu_torch.models import DRN, location_metadata

from torch_threads import one_torch_thread  # noqa: F401

FP32 = dict(atol=1e-4, rtol=1e-4)
# bf16, port (plain versions) vs the JAX package's XLA path: both round
# every conv block's output to bf16, but the port adds the conv bias to the
# fp32 accumulator where XLA adds it in bf16 after rounding, so outputs may
# differ by bf16 rounding flips carried through the layers: logits by a
# few bf16 ulps of their scale, segments (base-grid units, up to
# num_clips) through the exponent of the soft-capped distances.
BF16_TOL = {"d_start": (0.15, 0.05), "d_end": (0.15, 0.05),
            "match_logits": (0.05, 0.05), "iou_logits": (0.05, 0.05),
            "segments": (0.15, 0.05)}
OUTPUTS = ("d_start", "d_end", "match_logits", "iou_logits", "segments")


def _config(dtype="float32", num_levels=2, num_clips=32):
    cfg = jax_get_config("synthetic_tiny")
    ranges = tuple((i / num_levels, (i + 1) / num_levels)
                   for i in range(num_levels))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype=dtype,
                                  num_levels=num_levels,
                                  level_ranges=ranges),
        data=dataclasses.replace(cfg.data, num_clips=num_clips,
                                 synthetic_examples=12))


def _port_config(cfg):
    """The port's config with the same field values."""
    base = get_config(cfg.name)
    return base.replace(
        model=dataclasses.replace(base.model,
                                  **dataclasses.asdict(cfg.model)),
        data=dataclasses.replace(base.data, **dataclasses.asdict(cfg.data)),
        eval=dataclasses.replace(base.eval, **dataclasses.asdict(cfg.eval)))


def _jax_params(cfg, seed=0):
    """DRN.init params, every leaf shifted by seeded noise, as numpy."""
    model = jax_build_model(cfg)
    params = jax.device_get(jax_init_params(cfg, model, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


class _Pair:
    """One config's JAX model + params and the port's model on the same
    weights, and one synthetic batch."""

    def __init__(self, cfg):
        self.cfg, self.tcfg = cfg, _port_config(cfg)
        self.jmodel = jax_build_model(cfg)
        self.params = _jax_params(cfg)
        self.model = DRN(self.tcfg.model, base_len=cfg.data.num_clips)
        self.model.load_state_dict(
            flax_params_to_state_dict(self.params, self.tcfg.model))
        self.model.eval()
        ds = JaxSyntheticDataset(cfg.data, cfg.model, split="test")
        self.batch = next(JaxBatchIterator(ds, cfg.eval.batch_size,
                                           shuffle=False).epoch(0))

    def p(self, name):
        return {"params": self.params["params"][name]}

    def inputs(self):
        b = self.batch
        return b["features"], b["word_ids"], b["query_mask"]


_PAIRS = {}


def _pair(**kw) -> _Pair:
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        _PAIRS[key] = _Pair(_config(**kw))
    return _PAIRS[key]


def _close(got, want, atol, rtol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rng_levels(cfg, seed):
    rng = np.random.default_rng(seed)
    b, d = cfg.eval.batch_size, cfg.model.hidden_dim
    return [rng.standard_normal((b, cfg.data.num_clips // 2 ** l, d)
                                ).astype(np.float32)
            for l in range(cfg.model.num_levels)]


# --- (b) per module ---------------------------------------------------


def test_query_encoder_matches_jax():
    pr = _pair()
    _, ids, mask = pr.inputs()
    want = JaxQueryEncoder(pr.cfg.model).apply(pr.p("query_encoder"),
                                               jnp.asarray(ids),
                                               jnp.asarray(mask))
    with torch.no_grad():
        got = pr.model.query_encoder(_t(ids), _t(mask))
    assert len(got) == len(want) == pr.cfg.model.num_levels
    for g, w in zip(got, want):
        _close(g, w, **FP32)


def test_backbone_matches_jax():
    pr = _pair()
    feats = pr.inputs()[0]
    want = JaxBackbone(pr.cfg.model).apply(pr.p("backbone"),
                                           jnp.asarray(feats))
    with torch.no_grad():
        got = pr.model.backbone(_t(feats))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, **FP32)


def test_fusion_matches_jax():
    pr = _pair()
    cfg = pr.cfg
    levels = _rng_levels(cfg, 1)
    rng = np.random.default_rng(2)
    queries = [np.tanh(rng.standard_normal(
        (cfg.eval.batch_size, cfg.model.hidden_dim))).astype(np.float32)
        for _ in levels]
    with torch.no_grad():
        got = pr.model.fusion([_t(v) for v in levels],
                              [_t(q) for q in queries])
    for l, (v, q) in enumerate(zip(levels, queries)):
        want = JaxFusion(cfg.model).apply(pr.p(f"fusion_{l}"),
                                          jnp.asarray(v), jnp.asarray(q))
        _close(got[l], want, **FP32)


def test_fpn_matches_jax():
    pr = _pair()
    levels = _rng_levels(pr.cfg, 3)
    want = JaxFPN(pr.cfg.model).apply(pr.p("fpn"),
                                      [jnp.asarray(v) for v in levels])
    with torch.no_grad():
        got = pr.model.fpn([_t(v) for v in levels])
    for g, w in zip(got, want):
        _close(g, w, **FP32)


def test_grounding_heads_match_jax():
    pr = _pair()
    pyramid = _rng_levels(pr.cfg, 4)
    want = JaxHeads(pr.cfg.model).apply(pr.p("heads"),
                                        [jnp.asarray(v) for v in pyramid])
    with torch.no_grad():
        got = pr.model.heads([_t(v) for v in pyramid])
    for g, w in zip(got, want):  # d_start, d_end, match_logits
        _close(g, w, **FP32)


@pytest.mark.parametrize("num_levels,num_clips", [
    (2, 32),    # synthetic_tiny: flat sampling in the JAX package
    (4, 256),   # N=480: blocked sampling
    (4, 512),   # N=960: blocked sampling with mix_0 folded
])
def test_iou_head_matches_jax(num_levels, num_clips):
    cfg = _config(num_levels=num_levels, num_clips=num_clips)
    params = _jax_params(cfg)
    model = DRN(_port_config(cfg).model, base_len=num_clips)
    model.load_state_dict(flax_params_to_state_dict(params, cfg.model))
    pyramid = _rng_levels(cfg, 5)
    _, strides, level_ids = location_metadata(cfg.model, num_clips)
    n = strides.shape[0]
    rng = np.random.default_rng(6)
    a, b = rng.uniform(0, num_clips, size=(2, cfg.eval.batch_size, n))
    segs = np.stack([np.minimum(a, b), np.maximum(a, b)], -1
                    ).astype(np.float32)
    want = JaxIoUHead(cfg.model).apply(
        {"params": params["params"]["iou_head"]},
        [jnp.asarray(v) for v in pyramid], jnp.asarray(segs),
        jnp.asarray(level_ids.numpy().astype(np.int32)),
        jnp.asarray(strides.numpy()))
    with torch.no_grad():
        got = model.iou_head([_t(v) for v in pyramid], _t(segs), level_ids,
                             strides)
    _close(got, want, **FP32)


# --- (c) the whole eval step -----------------------------------------


def _eval_both(pr):
    feats, ids, mask = pr.inputs()
    jout = jax.device_get(pr.jmodel.apply(
        pr.params, jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(mask)))
    jstep = jax.device_get(jax_make_eval_step(pr.cfg, pr.jmodel)(
        pr.params, {k: jnp.asarray(v) for k, v in pr.batch.items()}))
    with torch.no_grad():
        tout = pr.model(_t(feats), _t(ids), _t(mask))
    tstep = make_eval_step(pr.tcfg, pr.model)(to_device(pr.batch, "cpu"))
    return jout, jstep, tout, tstep


@pytest.mark.parametrize("num_levels,num_clips", [(2, 32), (4, 256)])
def test_eval_step_matches_jax_fp32(num_levels, num_clips):
    pr = _pair(num_levels=num_levels, num_clips=num_clips)
    jout, jstep, tout, tstep = _eval_both(pr)
    for k in OUTPUTS:
        _close(tout[k], jout[k], **FP32)
    jcounts, jn, jsegs, jkeep, jscores = jstep
    tcounts, tn, tsegs, tkeep, tscores = tstep
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    _close(tscores, jscores, **FP32)
    _close(tsegs, jsegs, atol=1e-3, rtol=1e-4)  # seconds: grid × 60/T
    assert float(tn) == float(jn)
    assert set(tcounts) == set(jcounts)
    for k, v in jcounts.items():
        if k == MIOU_KEY:
            np.testing.assert_allclose(float(tcounts[k]), float(v),
                                       rtol=1e-4)
        else:
            assert float(tcounts[k]) == float(v), k


def test_eval_step_matches_jax_bf16():
    pr = _pair(dtype="bfloat16")
    jout, jstep, tout, tstep = _eval_both(pr)
    for k in OUTPUTS:
        atol, rtol = BF16_TOL[k]
        _close(tout[k], jout[k], atol=atol, rtol=rtol)
    assert float(tstep[1]) == float(jstep[1])


def test_ragged_batch_rows_match_jax():
    """The last batch is padded: valid False, query_mask[:, 0] True,
    gt_grid [0, 1] in padded rows, as the JAX package pads it."""
    cfg = _config()
    jds = JaxSyntheticDataset(cfg.data, cfg.model, split="test")
    tds = SyntheticDataset(_port_config(cfg).data, _port_config(cfg).model,
                           split="test")
    jb = list(JaxBatchIterator(jds, 8, shuffle=False).epoch(0))
    tb = list(BatchIterator(tds, 8, shuffle=False).epoch(0))
    assert len(tb) == len(jb) == 2
    for j, t in zip(jb, tb):
        assert set(j) == set(t)
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k])
    assert not tb[1]["valid"][4:].any() and tb[1]["query_mask"][4:, 0].all()


# --- (d) the weight bridge --------------------------------------------


def test_bridge_round_trips_through_the_parity_converter():
    pr = _pair()
    sd = flax_params_to_state_dict(pr.params, pr.tcfg.model)
    back = torch_state_to_flax(sd, pr.cfg.model)
    want = jax.tree_util.tree_leaves_with_path(pr.params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_state_dict_schema_is_the_parity_schema(tmp_path):
    """Same keys and shapes as TorchDRNParity, and a parity-schema .pth
    (wrapped as the reference saves it) loads into the port as it is."""
    cfg = _config()
    ref = TorchDRNParity(cfg.model, base_len=cfg.data.num_clips)
    model = DRN(_port_config(cfg).model, base_len=cfg.data.num_clips)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 1, "model": ref.state_dict()}, path)
    model.load_state_dict(load_torch_checkpoint(str(path)))
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
