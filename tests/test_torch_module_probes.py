"""The port's module probes (drn_tpu_torch/probes/{nms_probe,
profile_components,profile_residual,iou_mix_probe,sample_probe,embed_probe,
stem_probe,pallas_model_check}.py) on the CPU at tiny sizes: each probe's
variants against the JAX scripts' functions (scripts/<name>.py) and the
JAX `IoUHead` with its fold on and off, the generic chain of
`bench.CallChain`, and each probe's `main` printing its rows.

Tolerances: fp32 1e-5 for the samplers and the embedding gradients (one
or two products summed), 1e-4 for the IoU head (the conv mixes' order);
NMS orders, keep masks and sorted segments exactly; bf16 as each probe
states it. The rows' timings are CPU numbers, not checked; the chained
timing runs with one sample and no warm-up (`bench.chained_time` itself is
held by tests/test_torch_bench.py).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.models.drn import location_metadata as jax_location_metadata
from drn_tpu.models.heads import IoUHead as JaxIoUHead
from drn_tpu_torch import bench
from drn_tpu_torch import convert
from drn_tpu_torch.config import get_config
from drn_tpu_torch.models.heads import IoUHead
from drn_tpu_torch.models.layers import linear_time_sample
from drn_tpu_torch.ops.nms import batched_temporal_nms
from drn_tpu_torch.probes import (atscale_synthetic, embed_probe, int8_probe,
                                  iou_mix_probe, nms_probe,
                                  pallas_model_check, profile_components,
                                  profile_residual, recipe_demo,
                                  recipe_treatment_seeds,
                                  recipe_untrained_rescore_probe,
                                  sample_probe, stage2_regime_ab, stem_probe)
from scripts import embed_probe as jax_embed
from scripts import nms_probe as jax_nms
from scripts import sample_probe as jax_sample


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread (see tests/test_torch_probes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_sample(monkeypatch):
    monkeypatch.setattr(bench, "chained_time", functools.partial(
        bench.chained_time, warmup=0, reps=1))


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


# --- the generic chain ------------------------------------------------


def test_call_chain_perturbs_the_floats_and_folds_every_output():
    seen = []

    def fn(x, ids, pair):
        seen.append((x.clone(), ids.clone(), pair[0].clone()))
        return {"y": x * 2.0, "n": ids.sum()}, [pair[0]]

    x = torch.ones(3)
    ids = torch.tensor([1, 2], dtype=torch.int64)
    chain = bench.CallChain(fn, (x, ids, (torch.full((2,), 0.5),)))
    got = chain(3)
    assert chain.steps == 3 and len(seen) == 3
    # Each output leaf folded: 1e-6 · (Σ 2x + Σ ids + Σ pair).
    assert got == pytest.approx(1e-6 * (6.0 + 3 + 1.0))
    # The floats took the scalar (adding 0 leaves their values), the ints
    # passed through unchanged.
    assert all(torch.equal(a, x) and torch.equal(i, ids) for a, i, _ in seen)


def test_perturb_first_and_features_leave_the_rest_alone():
    a, b = torch.ones(2), torch.zeros(2)
    s = torch.tensor(3.0)
    out = bench.perturb_first((a, b), s)
    assert torch.equal(out[0], a) and out[0] is not a and out[1] is b
    batch = {"features": torch.ones(2, 3), "gt_grid": torch.zeros(2, 2)}
    (got,) = bench.perturb_features((batch,), s)
    assert got["gt_grid"] is batch["gt_grid"]
    assert got["features"] is not batch["features"]


# --- nms_probe against scripts/nms_probe.py ---------------------------


@pytest.mark.parametrize("row", ["fori_single", "package"])
@pytest.mark.parametrize("which", ["random", "chain"])
def test_nms_rows_equal_the_scripts_sweeps(which, row):
    segs, scores = nms_probe.make_inputs(4, 48)[which]
    fn = {"fori_single": nms_probe.fori_single,
          "package": batched_temporal_nms}[row]
    got = fn(torch.from_numpy(segs), torch.from_numpy(scores),
             nms_probe.THRESHOLD)
    for jax_fn in (jax_nms.nms_fori, jax_nms.nms_fix):
        want = jax.vmap(lambda s, c: jax_fn(s, c, nms_probe.THRESHOLD))(
            jnp.asarray(segs), jnp.asarray(scores))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_the_chain_input_suppresses_nothing_at_the_threshold():
    """The script's "adversarial" chain: starts 4 apart, length 10, so
    neighbours overlap 6 of 14 (IoU 0.43) and nothing is suppressed at
    0.5; at 0.4 each kept segment suppresses the next, every other one
    kept."""
    segs, scores = (torch.from_numpy(a) for a in
                    nms_probe.make_inputs(2, 48)["chain"])
    for fn in (nms_probe.fori_single, batched_temporal_nms):
        assert fn(segs, scores, nms_probe.THRESHOLD)[1].all()
        keep = fn(segs, scores, 0.4)[1]
        assert keep[:, ::2].all() and not keep[:, 1::2].any()


# --- sample_probe against scripts/sample_probe.py ---------------------

SAMPLERS = {
    "gather_sample": (sample_probe.gather_sample, jax_sample.gather_sample),
    "stacked_sel_sample": (sample_probe.stacked_sel_sample,
                           jax_sample.stacked_sel_sample),
    "shared_sel_sample": (sample_probe.shared_sel_sample,
                          jax_sample.shared_sel_sample),
    "onehot_sample fp32": (
        lambda f, p: sample_probe.onehot_sample(f, p, torch.float32),
        lambda f, p: jax_sample.onehot_sample(f, p, jnp.float32)),
    "onehot_sample bf16": (
        lambda f, p: sample_probe.onehot_sample(f, p, torch.bfloat16),
        lambda f, p: jax_sample.onehot_sample(f, p, jnp.bfloat16)),
}


def _sample_inputs(dtype):
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, 16, 8)).astype(np.float32)
    pos = rng.uniform(-1.0, 16.0, size=(2, 48)).astype(np.float32)
    pos[0, :3] = (0.0, 15.0, 7.0)  # the ends and a whole index
    jfeat = jnp.asarray(feat, dtype)
    tfeat = torch.from_numpy(np.array(jfeat.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return tfeat, torch.from_numpy(pos), jfeat, jnp.asarray(pos)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_each_sampler_matches_the_scripts(name, dtype):
    tfeat, tpos, jfeat, jpos = _sample_inputs(dtype)
    port, script = SAMPLERS[name]
    got = port(tfeat, tpos).float().numpy()
    want = np.asarray(script(jfeat, jpos), np.float32)
    # bf16 `onehot_sample`: both round the weights (and fp32 features) to
    # bf16; the script's product keeps fp32 (its preferred_element_type),
    # the port's bmm rounds it to bf16 once. Every other sampler picks the
    # same rows and lerps in fp32.
    tol = (sample_probe.BF16_REL * np.abs(want).max()
           if name == "onehot_sample bf16" else 1e-5)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_the_port_samples_as_gather_sample():
    for dtype in (jnp.float32, jnp.bfloat16):
        tfeat, tpos, _, _ = _sample_inputs(dtype)
        assert torch.equal(linear_time_sample(tfeat, tpos),
                           sample_probe.gather_sample(tfeat, tpos))


# --- embed_probe against scripts/embed_probe.py -----------------------


@pytest.mark.parametrize("name", list(embed_probe.VARIANTS))
def test_embedding_gradients_match_the_scripts(name):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(2, 64, (4, 5))
    ids[0, :3] = 7  # one id three times: the gradient sums its rows
    val, grad = embed_probe.value_and_grad(
        embed_probe.VARIANTS[name], torch.from_numpy(table),
        torch.from_numpy(ids))
    for script in (jax_embed.take_embed, jax_embed.matgrad_embed):
        loss = lambda t, script=script: jnp.sum(jnp.tanh(
            script(t, jnp.asarray(ids, jnp.int32))))
        want_val, want_grad = jax.value_and_grad(loss)(jnp.asarray(table))
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                                   atol=1e-5, rtol=0)
        assert val.item() == pytest.approx(float(want_val), abs=1e-4)


# --- iou_mix_probe against the JAX IoUHead, fold on and off -----------

CLIPS = 256  # synthetic_tiny's 2 levels: N = 256 + 128 locations


def _iou_configs(dtype, fold_min):
    jcfg = jax_get_config("synthetic_tiny")
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, dtype=dtype,
                                  iou_fold_mix_min_locations=fold_min),
        data=dataclasses.replace(jcfg.data, num_clips=CLIPS))
    pcfg = get_config("synthetic_tiny")
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, dtype=dtype),
                        data=dataclasses.replace(pcfg.data, num_clips=CLIPS))
    return jcfg, pcfg


def _iou_inputs(cfg):
    m = cfg.model
    rng = np.random.default_rng(1)
    sizes = [CLIPS // 2 ** l for l in range(m.num_levels)]
    pyramid = [rng.normal(size=(3, t, m.hidden_dim)).astype(np.float32)
               for t in sizes]
    segs = np.sort(rng.uniform(0, CLIPS, size=(3, sum(sizes), 2)),
                   axis=-1).astype(np.float32)
    _, strides, level_ids = jax_location_metadata(m, CLIPS)
    return pyramid, segs, np.array(level_ids), np.array(strides)


@functools.lru_cache(maxsize=None)
def _iou_pair(dtype):
    """JAX IoUHead params (seeded noise on the init) at `dtype`, and the
    port's IoUHead on the same weights."""
    jcfg, pcfg = _iou_configs(dtype, 0)
    pyramid, segs, level_ids, strides = _iou_inputs(jcfg)
    params = JaxIoUHead(jcfg.model).init(
        jax.random.key(0), [jnp.asarray(p) for p in pyramid],
        jnp.asarray(segs), jnp.asarray(level_ids), jnp.asarray(strides))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    sd = {}
    p = params["params"]
    for i in range(pcfg.model.iou_head_layers):
        convert._conv_block(sd, f"iou_mix.{i}", p[f"mix_{i}"])
    convert._conv(sd, "iou_out", p["out"])
    head = IoUHead(pcfg.model)
    head.load_state_dict(sd)
    return params, head


def _jax_iou(dtype, fold_min):
    jcfg, _ = _iou_configs(dtype, fold_min)
    pyramid, segs, level_ids, strides = _iou_inputs(jcfg)
    params, _ = _iou_pair(dtype)
    return np.asarray(JaxIoUHead(jcfg.model).apply(
        params, [jnp.asarray(p) for p in pyramid], jnp.asarray(segs),
        jnp.asarray(level_ids), jnp.asarray(strides)))


def _port_iou(dtype, folded):
    jcfg, _ = _iou_configs(dtype, 0)
    pyramid, segs, level_ids, strides = _iou_inputs(jcfg)
    _, head = _iou_pair(dtype)
    args = ([torch.from_numpy(p) for p in pyramid], torch.from_numpy(segs),
            torch.from_numpy(level_ids).long(), torch.from_numpy(strides))
    with torch.no_grad():
        out = (iou_mix_probe.folded_iou_head(head, *args) if folded
               else head(*args))
    return out.float().numpy()


@pytest.mark.parametrize("folded", [False, True], ids=["A", "B"])
def test_iou_mix_variants_match_the_jax_head(folded):
    """A against the JAX head with its fold off (its blocked sampling, N
    = 384 ≥ 256), B against it with the fold on, in fp32."""
    want = _jax_iou("float32", 0 if folded else 10 ** 9)
    np.testing.assert_allclose(_port_iou("float32", folded), want,
                               atol=1e-4, rtol=1e-4)


def test_iou_mix_a_against_b_in_bf16():
    a, b = _port_iou("bfloat16", False), _port_iou("bfloat16", True)
    rel = np.abs(a - b).max() / np.abs(a).max()
    assert 0 < rel <= iou_mix_probe.AB_REL_TOL


def test_the_fold_refuses_a_weight_of_another_width():
    _, head = _iou_pair("float32")
    jcfg, _ = _iou_configs("float32", 0)
    pyramid, segs, level_ids, strides = _iou_inputs(jcfg)
    narrow = [torch.from_numpy(p[..., :-8]) for p in pyramid]
    with pytest.raises(ValueError, match="mix_0 takes"):
        iou_mix_probe.folded_iou_head(
            head, narrow, torch.from_numpy(segs),
            torch.from_numpy(level_ids).long(), torch.from_numpy(strides))


# --- each probe's main on the CPU -------------------------------------

TINY = ["--device", "cpu", "--iters", "1"]
MAINS = {
    "nms_probe": (nms_probe, ["--batch-size", "4", "--top-k", "16"], 4),
    "profile_components": (profile_components,
                           ["--config", "synthetic_tiny"], 6),
    "profile_residual": (profile_residual, ["--config", "synthetic_tiny"],
                         5),
    "iou_mix_probe": (iou_mix_probe, ["--config", "synthetic_tiny"], 2),
    "sample_probe": (sample_probe, ["--shape", "2,16,8"], 5),
    "sample_probe --config": (sample_probe, ["--config", "synthetic_tiny"],
                              5),
    "embed_probe": (embed_probe, ["--shape", "4,5,64,8"], 2),
    "stem_probe": (stem_probe, ["--config", "synthetic_recipe",
                                "--batch-sizes", "2"], 3),
    "pallas_model_check": (pallas_model_check,
                           ["--config", "synthetic_tiny"], 7),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_prints_its_rows(name, capsys, one_sample):
    module, argv, n_rows = MAINS[name]
    assert module.main(argv + TINY) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert len(rows) == n_rows
    unit = "us" if name in ("nms_probe", "embed_probe") else "ms"
    for r in rows:
        assert r["probe"] == name.split()[0]
        assert isinstance(r["clamped"], bool)
        # Device time and kernels come from a trace of the card: none here.
        assert r[f"device_{unit}"] is None and r["kernels_per_call"] is None
        assert r.get("derived") or r[f"host_{unit}"] > 0
    if name == "nms_probe":
        assert [r["same_as_package"] for r in rows
                if r["row"] == "fori_single"] == [True, True]
    if name.startswith("sample_probe"):
        assert all(r["max_err"] <= r["tol"] for r in rows)
    if name == "embed_probe":
        assert rows[1]["max_grad_diff"] <= embed_probe.GRAD_TOL
        assert rows[1]["onehot_flops"] == 2 * 4 * 5 * 64 * 8
    if name == "stem_probe":
        assert [r["row"] for r in rows] == ["plain", "library",
                                            "kernel split=1"]


def test_model_check_variants_equal_plain_on_the_cpu(capsys, one_sample):
    """Off the card every wrapper runs its plain version, so each variant
    but `library` reproduces `plain` exactly and launches nothing."""
    assert pallas_model_check.main(["--config", "synthetic_tiny"]
                                   + TINY) == 0
    rows = {r["row"]: r for r in _json_lines(capsys.readouterr().out)}
    assert list(rows) == list(pallas_model_check.VARIANTS)
    for name, r in rows.items():
        assert r["launches"] == r["expected_launches"]
        assert not any(r["launches"].values())
        if name != "library":
            assert set(r["max_abs_diff"].values()) == {0.0}, name
    assert all(v <= 1 for v in rows["library"]["tol_ratio"].values())


def test_expected_launches_follow_the_ops():
    m = get_config("charades_c3d_batched_eval").model
    cuda = torch.device("cuda")
    want = {"fused_stem": 1, "fused_fusion_block": 3, "conv_ln_relu": 15,
            "fused_fusion": 0, "pallas_block": 0, "conv_ln_relu_bwd": 0,
            "fused_fusion_block_bwd": 0, "map_epilogue": 0}
    got = {k: pallas_model_check.expected_launches(ops, m, cuda)
           for k, ops in pallas_model_check.VARIANTS.items()}
    assert got["all"] == want
    assert got["stem+fusion"] == {**want, "conv_ln_relu": 0}
    assert got["conv_blocks"] == {**want, "fused_stem": 0,
                                  "fused_fusion_block": 0}
    assert not any(got["plain"].values()) and not any(
        got["library"].values())


# Each probe's main with no --device, and the arguments it requires.
REFUSERS = {
    **{k.split()[0]: (v[0], []) for k, v in MAINS.items()},
    "recipe_demo": (recipe_demo, []),
    "recipe_untrained_rescore_probe": (recipe_untrained_rescore_probe,
                                       ["--workdir", "unused"]),
    "recipe_treatment_seeds": (recipe_treatment_seeds,
                               ["--workdir", "unused"]),
    "stage2_regime_ab": (stage2_regime_ab, ["--workdir", "unused"]),
    "atscale_synthetic": (atscale_synthetic, []),
    "int8_probe": (int8_probe, []),
}


@pytest.mark.parametrize("name", sorted(REFUSERS))
def test_probes_refuse_the_cpu_unless_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = REFUSERS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
