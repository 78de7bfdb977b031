"""The port's recipe probes (drn_tpu_torch/probes/{recipe_demo,
recipe_untrained_rescore_probe,recipe_treatment_seeds,stage2_regime_ab,
atscale_synthetic,int8_probe}.py) on the CPU at `synthetic_tiny`, against
the JAX scripts they port (scripts/<name>.py, loaded by path as
tests/test_recipe.py loads scripts/recipe_demo.py). Nothing trains in JAX.

- The evaluation helpers against the JAX script's on the same weights
  (JAX's `init_params(key(0))`, converted): recall rows exactly, mIoU to
  1e-4, in fp32. The JAX evaluations share one model a rescore flag, so
  its eval step compiles twice in all.
- The IoU-head splice against the JAX probe's, state dicts exactly.
- The port's runs: one workdir, one stage 1 (`run_demo`, 1 + 1 epochs)
  that the other probes reuse, on the synthetic fixture cut to 32
  examples a split (4 steps an epoch at B=8) so the file stays within
  ~45 s alone. Their summaries carry the JAX summaries' keys (read from
  the scripts' dict literals); a second run of the resumable probes
  trains nothing and prints the same summary.
- `atscale_synthetic` rehearsed at `synthetic_tiny`, and failing when
  stage 2 moves the backbone.
- The int8 quantizers against a jnp restatement of
  scripts/int8_probe.py's bodies (:67-90): int8 operands and int32
  accumulators exactly, the rescaled output to 1e-6 relative. FP8 is held
  only on the card (tests/test_torch_cuda.py).
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_tpu.train as jax_train
from drn_tpu.config import get_config as jax_get_config
from drn_tpu_torch import config as port_config
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.evaluate import build_model
from drn_tpu_torch.probes import (atscale_synthetic, int8_probe, recipe_demo,
                                  recipe_treatment_seeds,
                                  recipe_untrained_rescore_probe,
                                  stage2_regime_ab)

from torch_threads import one_torch_thread  # noqa: F401

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
EXAMPLES = 32  # a split of the cut fixture


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_dict_keys(name):
    """The key sets of every dict literal with string keys in
    scripts/<name>.py (its summary lines are such literals)."""
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return [frozenset(k.value for k in node.keys)
            for node in ast.walk(tree) if isinstance(node, ast.Dict)
            and node.keys and all(isinstance(k, ast.Constant)
                                  and isinstance(k.value, str)
                                  for k in node.keys)]


def tiny(port: bool):
    """synthetic_tiny in fp32, w pinned to 1, the fixture cut to EXAMPLES
    a split; the port's config or the JAX package's."""
    cfg = (get_config if port else jax_get_config)("synthetic_tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32"),
        data=dataclasses.replace(cfg.data, synthetic_examples=EXAMPLES),
        eval=dataclasses.replace(cfg.eval, score_iou_weight=1.0))


def run_main(module, argv):
    """`module.main(argv)` → (its return code, the JSON lines of its
    stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


def test_r1_mean_and_fmt_equal_the_scripts():
    r = {"R@1,IoU=0.3": 60.0, "R@1,IoU=0.5": 34.5, "R@1,IoU=0.7": 15.25,
         "R@5,IoU=0.5": 77.0, "mIoU": 39.0}
    demo = load_script("recipe_demo")
    for name in ("recipe_demo", "recipe_treatment_seeds"):
        assert recipe_demo.r1_mean(r) == load_script(name).r1_mean(r)
    assert recipe_demo.fmt(r) == demo._fmt(r)


# --- evaluation and the IoU-head splice against the JAX scripts -------


@pytest.fixture(scope="module")
def jax_side():
    """JAX's init at key(0) and key(1) (numpy), the JAX probe's
    splice of key(1)'s IoU head into key(0)'s params, and the JAX demo's
    `_eval_with`, its models shared a config so each flag compiles once."""
    demo = load_script("recipe_demo")
    jcfg = tiny(port=False)
    models = {}

    def shared_model(cfg):
        return models.setdefault(repr(cfg), real(cfg))

    real = jax_train.build_model
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train, "build_model", shared_model)
    # init_params' body (jax.jit(model.init) on its dummy batch), one jit
    # for both keys, so it compiles once.
    d = jcfg.data
    init = jax.jit(real(jcfg).init)
    params, fresh = (jax.device_get(init(
        jax.random.key(s),
        jnp.zeros((2, d.num_clips, jcfg.model.feature_dim), jnp.float32),
        jnp.zeros((2, d.max_query_len), jnp.int32),
        jnp.ones((2, d.max_query_len), bool))) for s in (0, 1))
    # scripts/recipe_untrained_rescore_probe.py:114-119
    pseed = {**params, "params": {**params["params"],
                                  "iou_head": fresh["params"]["iou_head"]}}
    evals = {}

    def eval_jax(which, rescore):
        if (which, rescore) not in evals:
            p = {"params0": params, "spliced": pseed}[which]
            evals[which, rescore] = demo._eval_with(jcfg, p, rescore)
        return evals[which, rescore]

    yield dict(cfg=jcfg, params=params, fresh=fresh, pseed=pseed,
               eval=eval_jax)
    mp.undo()


def port_model(state):
    cfg = tiny(port=True)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    return cfg, model


def assert_same_eval(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "mIoU":
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        else:
            assert got[k] == pytest.approx(v, abs=1e-9), (k, got[k], v)


@pytest.mark.parametrize("rescore", [False, True])
def test_eval_with_equals_the_jax_script(jax_side, rescore):
    cfg, model = port_model(flax_params_to_state_dict(
        jax_side["params"], tiny(port=True).model))
    assert_same_eval(recipe_demo.eval_with(cfg, model, rescore),
                     jax_side["eval"]("params0", rescore))


def test_splice_iou_head_equals_the_jax_splice(jax_side):
    mcfg = tiny(port=True).model
    base = flax_params_to_state_dict(jax_side["params"], mcfg)
    fresh_cfg, fresh = port_model(flax_params_to_state_dict(
        jax_side["fresh"], mcfg))
    got = recipe_demo.splice_iou_head(base,
                                      recipe_demo.iou_head_state(fresh))
    want = flax_params_to_state_dict(jax_side["pseed"], mcfg)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    moved = [k for k in got if not torch.equal(got[k], base[k])]
    assert moved and all(fresh.owner(k) == "iou_head" for k in moved)
    _, model = port_model(got)
    assert_same_eval(recipe_demo.eval_with(fresh_cfg, model, True),
                     jax_side["eval"]("spliced", True))


def test_splice_refuses_keys_outside_the_state_dict():
    with pytest.raises(KeyError, match="outside"):
        recipe_demo.splice_iou_head({"a": torch.zeros(1)},
                                    {"iou_out.bias": torch.zeros(1)})


def test_reinit_iou_head_moves_only_the_iou_head():
    cfg = tiny(port=True)
    model = build_model(cfg, device="cpu", seed=5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    heads = []
    for seed in (0, 1):
        recipe_demo.reinit_iou_head(model, seed)
        after = model.state_dict()
        assert recipe_demo.moved_outside_iou_head(model, before, after) == []
        heads.append({k: v.clone() for k, v in
                      recipe_demo.iou_head_state(model).items()})
        assert any(not torch.equal(v, before[k])
                   for k, v in heads[-1].items())
    # The seeds draw every weight anew; LayerNorm scales and biases are
    # constants of the rule.
    assert [k for k in heads[0] if not torch.equal(heads[0][k], heads[1][k])
            ] == [k for k in heads[0] if "norm" not in k and "bias" not in k]
    # Seed s's head is the one the trainer's build_model(seed=s) draws.
    trainer = recipe_demo.iou_head_state(build_model(cfg, device="cpu",
                                                     seed=1))
    assert all(torch.equal(heads[1][k], v) for k, v in trainer.items())


def test_val_eval_fn_selects_as_the_trainers_own_eval():
    import drn_tpu_torch.train as port_train

    cfg = tiny(port=True)
    model = build_model(cfg, device="cpu")
    own = port_train._default_eval_fn(cfg, torch.device("cpu"))
    try:
        want = own(model, 0)
    finally:
        own.close()
    got = recipe_demo.val_eval_fn(cfg, recipe_demo.val_split(cfg))(model, 0)
    assert got == want


# --- the recipe runs: one workdir, one stage 1 --------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run_demo, then the three probes on its workdir, then the resumable
    two again with `train` counted; on the cut fixture."""
    work = str(tmp_path_factory.mktemp("recipe"))
    base = port_config.get_config("synthetic_tiny")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_config._REGISTRY, "synthetic_tiny", base.replace(
            data=dataclasses.replace(base.data,
                                     synthetic_examples=EXAMPLES)))
        info = {}
        out["demo"] = recipe_demo.run_demo(
            "synthetic_tiny", 1, 1, work, seed=0, device="cpu", run=info)
        out["demo_run"] = info
        cpu = ["--device", "cpu", "--config", "synthetic_tiny"]
        out["untrained"] = run_main(recipe_untrained_rescore_probe, [
            *cpu, "--seeds", "2",
            "--workdir", f"{work}/synthetic_tiny/stage1"])
        resumable = {
            "treatment": (recipe_treatment_seeds, [
                *cpu, "--seeds", "1", "--stage2-epochs", "1",
                "--w-sweep", "0.5", "--workdir", work]),
            "regime": (stage2_regime_ab, [
                *cpu, "--seeds", "1", "--stage2-epochs", "1",
                "--workdir", work])}
        for key, (module, argv) in resumable.items():
            out[key] = run_main(module, argv)
        import drn_tpu_torch.train as port_train

        calls = []
        real = port_train.train
        mp.setattr(port_train, "train",
                   lambda *a, **k: calls.append(a) or real(*a, **k))
        for key, (module, argv) in resumable.items():
            out[key + "_again"] = run_main(module, argv)
        out["train_calls_again"] = len(calls)
    return out


def test_run_demo_rows_and_the_frozen_grounding_heads(runs):
    results, info = runs["demo"], runs["demo_run"]
    assert tuple(results) == recipe_demo.ROWS
    with open(os.path.join(SCRIPTS, "recipe_demo.py")) as f:
        src = f.read()
    assert all(f'results["{row}"]' in src for row in recipe_demo.ROWS)
    assert results["stage2_plain"] == results["stage1"]
    assert info["moved_outside_iou_head"] == []
    assert set(info["seconds"]) == set(info["launches"]) == {
        "stage1_train", "stage1_eval", "stage2_train", "stage2_eval"}
    # On the CPU every wrapper runs its plain version: no launch.
    assert not any(v for d in info["launches"].values() for v in d.values())


@pytest.mark.parametrize("key,script", [
    ("demo", "recipe_demo"),
    ("untrained", "recipe_untrained_rescore_probe"),
    ("treatment", "recipe_treatment_seeds"),
    ("regime", "stage2_regime_ab")])
def test_summaries_carry_the_jax_keys(runs, key, script):
    dicts = script_dict_keys(script)
    if key == "demo":
        line = recipe_demo.summary(runs["demo"])
    else:
        rc, lines = runs[key]
        assert rc == 0 and lines[0]["run"] and len(lines) == 2
        line = lines[-1]
    if key == "regime":
        jax_regimes = load_script(script).REGIMES
        assert stage2_regime_ab.REGIMES == jax_regimes
        assert frozenset(set(line) - set(jax_regimes)) in dicts
        assert all(frozenset(line[r]) in dicts for r in jax_regimes)
    else:
        assert frozenset(line) in dicts
    if key == "treatment":
        assert line["seeds"] == [0]
        assert frozenset(line["w_sweep"]["w0.5"]) in dicts
    if key in ("demo", "untrained"):
        want = (recipe_demo.ROWS if key == "demo"
                else ("stage1_plain", "untrained_seed0", "untrained_seed1"))
        assert tuple(line["results"]) == want


def test_the_probes_reuse_the_demos_stage1(runs):
    # The untrained probe's baseline and seed-0 head are the demo's
    # stage 1 and its untrained rescore: the trainer drew that head at
    # seed 0.
    rows = runs["untrained"][1][-1]["results"]
    demo = recipe_demo.rounded(runs["demo"])
    assert rows["stage1_plain"] == demo["stage1"]
    assert rows["untrained_seed0"] == demo["stage1_rescore_untrained"]
    assert runs["regime"][1][-1]["stage1_r1_mean"] == round(
        recipe_demo.r1_mean(runs["demo"]["stage1"]), 2)


@pytest.mark.parametrize("key", ["treatment", "regime"])
def test_a_second_run_trains_nothing(runs, key):
    assert runs["train_calls_again"] == 0
    assert runs[key + "_again"][0] == 0
    assert runs[key + "_again"][1][-1] == runs[key][1][-1]


# --- atscale_synthetic ------------------------------------------------

ATSCALE_TINY = ["--device", "cpu", "--config", "synthetic_tiny",
                "--train-examples", "64", "--test-examples", "32",
                "--batch-size", "8"]


def test_atscale_rehearses_at_tiny():
    rc, lines = run_main(atscale_synthetic, [
        *ATSCALE_TINY, "--epochs1", "2", "--epochs2", "2"])
    (rec,) = lines
    assert rc == 0 and rec["moved_outside_iou_head"] == []
    assert rec["lift"]["R@1,IoU=0.5"] > 0
    assert set(rec["seconds"]) == {"stage1", "stage1_eval", "stage2",
                                   "stage2_eval"}


def test_atscale_fails_when_the_freeze_breaks(monkeypatch):
    real = atscale_synthetic.make_train_step

    def leaky(cfg, model, optimizer):
        step = real(cfg, model, optimizer)

        def run(batch, table=None):
            out = step(batch, table)
            if cfg.train.stage == 2:
                with torch.no_grad():
                    next(model.backbone.parameters()).add_(1e-3)
            return out

        return run

    monkeypatch.setattr(atscale_synthetic, "make_train_step", leaky)
    with pytest.raises(AssertionError, match="freeze moved"):
        run_main(atscale_synthetic, [*ATSCALE_TINY, "--epochs1", "1",
                                     "--epochs2", "1"])


# --- int8_probe -------------------------------------------------------


def jnp_int8(a, w):
    """scripts/int8_probe.py:67-90 restated: (qa, qw, int32 accumulators,
    the dynamic body's output, the pre-quantized body's)."""
    sa = jnp.max(jnp.abs(a), axis=1, keepdims=True) / 127.0
    qa = jnp.clip(jnp.round(a / sa), -127, 127).astype(jnp.int8)
    sw = jnp.max(jnp.abs(w), axis=0, keepdims=True) / 127.0
    qw = jnp.clip(jnp.round(w / sw), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(qa, qw, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    out = acc.astype(jnp.float32) * sa * sw
    return [np.asarray(x) for x in (qa, qw, acc, out, out)]


def test_int8_quantizers_equal_the_script():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 384)).astype(np.float32)
    w = rng.normal(size=(384, 64)).astype(np.float32)
    qa, qw, acc, out, out_preq = jnp_int8(jnp.asarray(a), jnp.asarray(w))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    pqa, _ = int8_probe.quantize_int8(ta, 1)
    pqw, psw = int8_probe.quantize_int8(tw, 0)
    np.testing.assert_array_equal(pqa.numpy(), qa)
    np.testing.assert_array_equal(pqw.numpy(), qw)
    got_acc = int8_probe.int8_product(pqa, int8_probe.column_major(pqw))
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), acc)
    for got, want in ((int8_probe.int8_body(ta, tw), out),
                      (int8_probe.int8_prequantized_body(
                          ta, int8_probe.column_major(pqw), psw), out_preq)):
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-6, rel


def test_int8_probe_rows_on_the_cpu():
    rc, rows = run_main(int8_probe, ["--device", "cpu", "--shape",
                                     "64,384,64", "--iters", "1"])
    assert rc == 0
    assert [r["row"] for r in rows] == [
        "bf16", "int8", "int8_prequantized", "fp8", "fp8_prequantized",
        "bf16_product", "int8_product", "fp8_product"]
    assert rows[1]["acc_equal"] and rows[1]["acc_mismatches"] == 0
    assert all(r["rel_err"] <= r["rel_tol"] for r in rows)
    assert rows[0]["speedup_vs_bf16"] == 1.0
    assert all(r["bound_by"] == "bytes" for r in rows)  # tiny products
    flops = 2 * 64 * 384 * 64
    assert all(r["tflops_equiv"] == pytest.approx(flops / r["us"] / 1e6)
               for r in rows)
