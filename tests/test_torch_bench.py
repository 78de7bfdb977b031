"""The port's bench (drn_tpu_torch/bench.py) against bench.py, on the CPU at
synthetic_tiny: the same batch from the same seed, the same model
overrides, the same contract line; the eval chain's consumed scalar and the
train chain's loss against the JAX package's steps on the same weights
(carried by convert.py) at fp32 (and D=256); the FLOP counts against
bench.py's; the command's output.

Tolerances: the eval step's recall counts, n_valid and keep mask exactly,
its scores and segments and the train loss after two steps 1e-4 (fp32,
summation order only; the bar of tests/test_torch_train.py's
`test_train_steps_match_jax`); the eval fold 1e-6 against bench.py's fold
of the JAX step's outputs, and each of its five terms alone against
bench.py's weight 1e-6 (a fold that dropped one would read 0); FLOPs 10%
(bench.py's count is XLA's cost
analysis, which also counts element-wise work the port's matmul + conv
count leaves out).
"""

import argparse
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from drn_tpu.config import get_config as jax_get_config
from drn_tpu.evaluate import make_eval_step as jax_make_eval_step
from drn_tpu.train import TrainState
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import make_optimizer as jax_make_optimizer
from drn_tpu.train import make_train_step as jax_make_train_step
from drn_tpu_torch import bench
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.models import DRN

from torch_threads import one_torch_thread  # noqa: F401


def _tiny(cfg):
    """synthetic_tiny at fp32 and D=256: at its own D=64 the IoU head's
    selection products, a gather in the port, are 12% of the JAX FLOP
    count (tests/test_torch_utils.py pins that difference)."""
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32",
                                                 hidden_dim=256))


class _Pair:
    """The JAX model and its params (bench.py's own `_init_params`: every
    leaf N(0, 0.02²), drawn on the host), bench.py's batch (B=8, the
    config's eval and train batch), the config of each package, and the
    JAX package's jitted steps, compiled once for the tests below."""

    def __init__(self):
        self.jcfg = _tiny(jax_get_config("synthetic_tiny"))
        self.cfg = _tiny(get_config("synthetic_tiny"))
        assert self.cfg.data.batch_size == self.cfg.eval.batch_size
        self.jmodel = jax_build_model(self.jcfg)
        self.params = jax_bench._init_params(
            self.jcfg, self.jmodel, jax.random.key(0), keep_on_host=True)
        self.jbatch = jax_bench.make_bench_batch(self.jcfg)

    @functools.cached_property
    def eval_step(self):
        return jax_make_eval_step(self.jcfg, self.jmodel)

    @functools.cached_property
    def train_step(self):
        return jax_make_train_step(self.jcfg, self.jmodel, None)

    def state(self):
        return TrainState.create(
            apply_fn=self.jmodel.apply, params=self.jax_params(),
            tx=jax_make_optimizer(self.jcfg, 1))

    def model(self):
        model = DRN(self.cfg.model, base_len=self.cfg.data.num_clips)
        model.load_state_dict(flax_params_to_state_dict(self.params,
                                                        self.cfg.model))
        return model

    def jax_params(self):
        return jax.tree_util.tree_map(jnp.asarray, self.params)

    def batch(self):
        return bench.make_bench_batch(self.cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _Pair()


@pytest.mark.parametrize("batch_size", [None, 5])
def test_bench_batch_equals_bench_py(batch_size):
    want = jax.device_get(jax_bench.make_bench_batch(
        jax_get_config("synthetic_tiny"), seed=3, batch_size=batch_size))
    got = bench.make_bench_batch(get_config("synthetic_tiny"), seed=3,
                                 batch_size=batch_size, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert len(got["valid"]) == (batch_size or 8)


@pytest.mark.parametrize("override,value", [
    ("iou_fold_mix_min_locations=0", 0), ("use_pallas_stem=true", True),
    ("use_pallas_stem=off", False), ("use_pallas_stem=maybe", None)])
def test_model_override_matches_bench_py(override, value):
    jcfg, cfg = jax_get_config("charades_c3d"), get_config("charades_c3d")
    if value is None:
        with pytest.raises(SystemExit, match="not recognized"):
            jax_bench.apply_model_override(jcfg, override)
        with pytest.raises(SystemExit, match="not recognized"):
            bench.apply_model_override(cfg, override)
        return
    want = jax_bench.apply_model_override(jcfg, override)
    got = bench.apply_model_override(cfg, override)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    field = override.split("=")[0]
    assert getattr(got.model, field) == value
    assert type(getattr(got.model, field)) is type(value)


@pytest.mark.parametrize("config", ["charades_c3d_batched_eval", "tacos_c3d"])
def test_contract_line_matches_bench_py(config):
    args = argparse.Namespace(config=config, iters=7)
    for values in ((1234.5678, 0.012345678, 21.456, 5678.123, 0.0456789),
                   (99.0, None, None, None, None)):
        want = json.loads(jax_bench._contract_line(args, *values))
        got = json.loads(bench.contract_line(args, *values))
        assert got == want
        assert list(got) == list(want)


def _jax_fold(outputs):
    """bench.py:244-249 on the JAX step's outputs, in fp32."""
    counts, n_valid, segs, keep, scores = jax.device_get(outputs)
    f32 = np.float32
    return (f32(n_valid) + f32(1e-6) * np.sum(scores, dtype=f32)
            + f32(1e-9) * (np.sum(segs, dtype=f32)
                           + np.sum(np.asarray(keep, f32)))
            + f32(1e-9) * sum(f32(v) for v in counts.values()))


def test_eval_chain_folds_what_the_jax_step_returns(pair):
    """Output by output, the chain's step against the JAX step (the counts,
    n_valid and the keep mask exactly, the scores and the segments at
    1e-4), then the chain's scalar: `fold_eval` of those outputs, equal to
    bench.py's fold of the JAX step's. That each output counts in the fold
    is `test_fold_eval_keeps_every_output_live`'s: at this size the fold
    is n_valid plus ~1e-4, so the last comparison alone would not see a
    term go missing."""
    jcounts, jn, jsegs, jkeep, jscores = jax.device_get(
        pair.eval_step(pair.jax_params(), pair.jbatch))
    chain = bench.eval_chain(pair.cfg, pair.model().eval(), pair.batch())
    out = chain.step(pair.batch())
    counts, n_valid, segs, keep, scores = out
    assert {k: float(v) for k, v in counts.items()} == \
        {k: float(v) for k, v in jcounts.items()}
    assert float(n_valid) == float(jn) == 8
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < keep.numel()
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(segs.numpy(), jsegs, rtol=1e-4, atol=1e-4)
    got = chain(1)
    assert got == float(bench.fold_eval(out))
    np.testing.assert_allclose(got, float(_jax_fold(
        (jcounts, jn, jsegs, jkeep, jscores))), rtol=1e-6)
    # Each step adds 0.0 times the last scalar: the same step again.
    assert chain(2) == got and chain.steps == 3


# bench.py:244-249's weights: n_valid, the scores, the segments, the keep
# mask, each recall count.
FOLD_WEIGHTS = {"n_valid": 1.0, "scores": 1e-6, "segs": 1e-9, "keep": 1e-9,
                "counts": 1e-9}


@pytest.mark.parametrize("term", list(FOLD_WEIGHTS))
def test_fold_eval_keeps_every_output_live(term):
    """Each output alone (every other one zero) reaches the fold with
    bench.py's weight: a fold that dropped it would read 0."""
    value = 1234.0
    zeros = {"n_valid": torch.zeros(()), "scores": torch.zeros(2, 3),
             "segs": torch.zeros(2, 3, 2), "keep": torch.zeros(2, 3),
             "counts": {(1, 0.5): torch.zeros(()),
                        (5, 0.7): torch.zeros(())}}
    if term == "counts":
        zeros["counts"] = {(1, 0.5): torch.tensor(value / 2),
                           (5, 0.7): torch.tensor(value / 2)}
    else:
        t = zeros[term]
        zeros[term] = torch.full_like(t, value / max(t.numel(), 1))
    got = bench.fold_eval(tuple(zeros[k] for k in (
        "counts", "n_valid", "segs", "keep", "scores")))
    np.testing.assert_allclose(float(got), FOLD_WEIGHTS[term] * value,
                               rtol=1e-6)


def test_train_chain_matches_two_jax_steps(pair):
    jstate, losses = pair.state(), []
    for _ in range(2):
        jstate, metrics = pair.train_step(jstate, pair.jbatch)
        losses.append(float(metrics["loss"]))
    assert losses[1] != losses[0]  # the update is live
    chain = bench.train_chain(pair.cfg, pair.model().train(), pair.batch())
    np.testing.assert_allclose(chain(2), losses[1], rtol=1e-4, atol=1e-4)


def test_flops_within_a_tenth_of_bench_py(pair):
    """The eval step's count (`Chain.flops`, through the kernels' wrappers)
    and the train step's model count (`train_model_flops`) against
    `bench._step_flops` of the JAX package's steps (its train step is
    bench.py's `one_step`: the forward, `drn_loss`, the backward and the
    update)."""
    want_eval = jax_bench._step_flops(pair.eval_step,
                                      (pair.jax_params(), pair.jbatch))
    want_train = jax_bench._step_flops(pair.train_step,
                                       (pair.state(), pair.jbatch))
    got_eval = bench.eval_chain(pair.cfg, pair.model().eval(),
                                pair.batch()).flops()
    got_train = bench.train_model_flops(pair.cfg, pair.batch(), "cpu")
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert want and abs(got - want) <= 0.1 * want, (got, want)
    # The kernels' backward recomputes each block's forward: more work
    # than the model's.
    assert bench.train_chain(pair.cfg, pair.model().train(),
                             pair.batch()).flops() > 1.1 * got_train


@pytest.mark.parametrize("per_k,want", [
    # (host s of a run of k steps) → (per-step s, k=1 s, clamped)
    (lambda k: 0.25 + 0.5 * k, (0.5, 0.75, False)),
    (lambda k: 1.0 / k, (1e-9, 1.0, True))])
def test_chained_time_and_its_clamp(monkeypatch, per_k, want):
    """The medians' difference over iters on a clock that each run advances
    by `per_k(k)`; a chain that reads no slower than one step is clamped,
    and says so."""
    clock, calls = [0.0], []
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock[0])

    def run_k(k):
        calls.append(k)
        clock[0] += per_k(k)
        return 0.0

    got = bench.chained_time(run_k, 4, warmup=1, reps=3)
    assert calls == [1] * 4 + [5] * 4
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12)
    assert got[2] is want[2]


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def test_main_prints_only_contract_lines(capsys):
    rc = bench.main(["--device", "cpu", "--config", "synthetic_tiny",
                     "--iters", "1", "--batch-size", "2", "--skip-torch"])
    out, err = capsys.readouterr()
    assert rc == 0
    first, enriched = _lines(out)
    keys = list(json.loads(jax_bench._contract_line(
        argparse.Namespace(config="synthetic_tiny", iters=1),
        1.0, None, None, None, None)))
    assert list(first) == list(enriched) == keys
    assert first["metric"] == \
        "synthetic_tiny_grounding_queries_per_sec_per_chip"
    assert first["train_examples_per_sec"] is None and first["iters"] == 1
    assert enriched["value"] == first["value"] > 0
    assert enriched["train_examples_per_sec"] > 0
    # Off the card no mfu (the peak is the H100's).
    assert first["mfu"] is None and enriched["train_mfu"] is None
    # stderr: the launch counts of the run and the steps it ran: warmup 2 +
    # reps 5 at k=1 and at k=1+iters, and the eval FLOP estimate's step;
    # the train chain at max(iters // 2, 4) (its FLOPs are counted on a
    # model of the plain versions, `train_model_flops`).
    runs = [rec for rec in map(json.loads, (
        ln for ln in err.splitlines() if ln.startswith("{")))
            if "launches" in rec]
    assert len(runs) == 1
    assert runs[0]["steps"] == {"eval": 7 * 1 + 7 * 2 + 1,
                                "train": 7 * 1 + 7 * 5}
    assert set(runs[0]["launches"]) == {"fused_stem", "fused_fusion_block",
                                        "conv_ln_relu", "fused_fusion",
                                        "pallas_block", "conv_ln_relu_bwd",
                                        "fused_fusion_block_bwd",
                                        "map_epilogue", "nms_sweep"}


def test_main_latency_line(capsys):
    assert bench.main(["--device", "cpu", "--config", "synthetic_tiny",
                       "--iters", "2", "--latency"]) == 0
    (line,) = _lines(capsys.readouterr().out)
    assert line["metric"] == "synthetic_tiny_single_query_latency_us"
    assert line["unit"] == "us" and line["value"] > 0
    assert line["vs_baseline"] is None and line["iters"] == 2


def test_all_configs_goes_on_past_a_failure_and_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(bench, "ALL_CONFIGS", ("no_such_config",
                                               "synthetic_tiny"))
    assert bench.main(["--device", "cpu", "--iters", "1",
                       "--all-configs"]) == 1
    out, err = capsys.readouterr()
    (line,) = _lines(out)
    assert line["metric"] == \
        "synthetic_tiny_grounding_queries_per_sec_per_chip"
    assert line["train_examples_per_sec"] is None
    assert "no_such_config" in err and "1/2 configs failed" in err
