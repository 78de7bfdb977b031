"""The port's probes of the host path and the train step
(drn_tpu_torch/probes/{host_pipeline,staged_eval,train_probe,train_mfu}.py)
on the CPU at tiny sizes: the corpus builder against the JAX package's
(scripts/host_pipeline_probe.py), and each probe's `main` printing its rows.

The rows' timings are CPU numbers, not checked. The chained timing runs
with one sample and no warm-up here (`bench.chained_time` itself is held
by tests/test_torch_bench.py), so each row costs a few steps. No worker
pool is started (WorkerBatchIterator: tests/test_torch_workers.py).
"""

import functools
import json

import pytest

from drn_tpu_torch import bench
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch.config import get_config
from drn_tpu_torch.probes import host_pipeline, staged_eval, train_mfu
from drn_tpu_torch.probes import train_probe
from drn_tpu_torch.train import make_optimizer
from scripts import host_pipeline_probe as jax_host_pipeline

from torch_threads import one_torch_thread  # noqa: F401

CORPUS = dict(videos=5, dim=16, rows_lo=8, rows_hi=12, queries_per_video=3)


@pytest.fixture
def one_sample(monkeypatch):
    monkeypatch.setattr(bench, "chained_time", functools.partial(
        bench.chained_time, warmup=0, reps=1))


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file()}


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_build_corpus_is_byte_equal_to_the_jax_builder(tmp_path):
    got = host_pipeline.build_corpus(str(tmp_path / "port"), *CORPUS.values())
    want = jax_host_pipeline.build_corpus(str(tmp_path / "jax"),
                                          *CORPUS.values())
    for k in ("examples", "raw_gb", "bytes_per_example"):
        assert got[k] == want[k], k
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(port) == CORPUS["videos"] + 1 and port == jax


def test_a_second_build_writes_the_same_corpus(tmp_path):
    """The port draws every video's features again where the file exists;
    the JAX builder skips the draw, so its second annotation differs."""
    host_pipeline.build_corpus(str(tmp_path / "port"), *CORPUS.values())
    first = _files(tmp_path / "port")
    host_pipeline.build_corpus(str(tmp_path / "port"), *CORPUS.values())
    assert _files(tmp_path / "port") == first
    ann = tmp_path / "jax" / "charades_sta_train.txt"
    jax_host_pipeline.build_corpus(str(tmp_path / "jax"), *CORPUS.values())
    before = ann.read_bytes()
    jax_host_pipeline.build_corpus(str(tmp_path / "jax"), *CORPUS.values())
    assert ann.read_bytes() != before


def test_host_pipeline_main(tmp_path, capsys):
    assert host_pipeline.main([
        "--device", "cpu", "--out", str(tmp_path), "--videos", "5",
        "--dim", "16", "--rows", "8,12", "--queries-per-video", "3",
        "--num-clips", "8", "--batch-size", "4", "--workers", "",
        "--device-qps", "100"]) == 0
    *rows, summary = _json_lines(capsys.readouterr().out)
    assert [(r["native_reader"], r["feature_cache_mb"], r["epoch"])
            for r in rows] == [
        (native, cache, epoch) for native in (True, False)
        for cache in (0.0, 64.0) for epoch in ("cold", "warm")]
    assert all(r["examples"] == 15 and r["examples_per_s"] > 0
               for r in rows)
    assert all((r["native_reads"] > 0) == r["native_reader"] for r in rows)
    assert summary["probe"] == "host_pipeline"
    assert summary["device_qps"] == 100.0
    assert summary["device_qps_source"] == "given"
    assert summary["results"] == rows and summary["device"] == "cpu"


STAGED_ARGS = ["--device", "cpu", "--config", "synthetic_tiny", "--videos",
               "4", "--dim", "16", "--rows", "8,12", "--queries-per-video",
               "3", "--epochs", "1"]


def test_staged_eval_main(tmp_path, capsys):
    assert staged_eval.main(STAGED_ARGS + ["--out", str(tmp_path)]) == 0
    out, err = capsys.readouterr()
    rows = _json_lines(err)
    assert [r["phase"] for r in rows] == [
        "streaming_epoch_cold", "streaming_epoch_warm", "staging_pass",
        "staged_epoch_0"]
    summary = _json_lines(out)[-1]
    assert summary["metrics_match"] and summary["corpus_examples"] == 12
    cfg, model, ds = _staged_model_and_data(tmp_path)
    assert summary["metrics"] == port_eval.evaluate(cfg, model, ds,
                                                    device="cpu") \
        == port_eval.evaluate(cfg, model, ds, device="cpu",
                              device_features=True)


def test_evaluate_refuses_a_table_without_its_batches(tmp_path):
    cfg, model, ds = _staged_model_and_data(tmp_path)
    table, _ = port_eval.stage_on_device(ds, "cpu")
    with pytest.raises(ValueError, match="batches"):
        port_eval.evaluate(cfg, model, ds, device="cpu", table=table)


def _staged_model_and_data(root):
    stats = host_pipeline.build_corpus(str(root), 4, 16, 8, 12, 3)
    cfg = host_pipeline.corpus_config(get_config("synthetic_tiny"), str(root),
                                      stats, 16)
    return cfg, port_eval.build_model(cfg, device="cpu", seed=0), \
        port_eval.make_dataset(cfg.data, cfg.model, split="train")


def test_staged_eval_raises_when_the_metrics_differ(tmp_path, monkeypatch):
    real = port_eval.evaluate

    def off_by_one(*a, table=None, **kw):
        res = real(*a, table=table, **kw)
        return {k: v + (table is not None) for k, v in res.items()}

    monkeypatch.setattr(port_eval, "evaluate", off_by_one)
    with pytest.raises(RuntimeError, match="staged metrics differ"):
        staged_eval.main(STAGED_ARGS + ["--out", str(tmp_path)])


def test_train_probe_main(capsys, one_sample):
    assert train_probe.main(["--device", "cpu", "--config", "synthetic_tiny",
                             "--batch-size", "2", "--iters", "1"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["row"] for r in rows] == [
        "loss_fwd", "fwd_bwd", "fwd_bwd_adam"] + [
        f"fwd_bwd_without_{g}" for g in train_probe.GROUPS]
    assert all(r["batch_size"] == 2 and r["ms"] > 0 for r in rows)
    # Model FLOPs, as train_mfu counts them: the optimizer adds none; a
    # frozen group's weight gradients drop out; no mfu off the card.
    flops = {r["row"]: r["flops_per_step"] for r in rows}
    assert flops["fwd_bwd"] == flops["fwd_bwd_adam"] > flops[
        "fwd_bwd_without_query_encoder"] > flops["loss_fwd"] > 0
    assert all(r["mfu"] is None and isinstance(r["clamped"], bool)
               for r in rows)


def test_frozen_restores_each_flag():
    cfg = get_config("synthetic_tiny")
    model = port_eval.build_model(cfg, device="cpu").train()
    make_optimizer(cfg, 1, model)  # the LSTMs' constant biases: False
    sd = model.state_dict(keep_vars=True)
    before = {k: p.requires_grad for k, p in sd.items()}
    assert not all(before.values()) and any(before.values())
    with train_probe.frozen(model, ("fusion", "fpn")):
        for k, p in sd.items():
            want = before[k] and model.owner(k) not in ("fusion", "fpn")
            assert p.requires_grad == want, k
    assert {k: p.requires_grad for k, p in sd.items()} == before


def test_train_mfu_main(capsys, one_sample):
    assert train_mfu.main(["--device", "cpu", "--config", "synthetic_tiny",
                           "--batch-size", "2", "--iters", "1", "--probes",
                           ",".join(train_mfu.PROBES)]) == 0
    rows = {r["probe"]: r for r in _json_lines(capsys.readouterr().out)}
    assert list(rows) == ["fwd", "grad", "full", "adam", "grad_noenc",
                          "grad_remat", "fp32 grad"]
    flops = {k: r["flops_per_step"] for k, r in rows.items()}
    # Model FLOPs: the optimizer and the recompute add none; without the
    # query encoder's weight gradients, fewer.
    assert flops["grad"] == flops["full"] == flops["grad_remat"] \
        == flops["fp32 grad"] > flops["grad_noenc"] > flops["fwd"] > 0
    assert flops["adam"] == 0
    assert rows["fp32 grad"]["dtype"] == "float32"
    assert all(r["mfu"] is None and r["ms"] > 0 for r in rows.values())
    with pytest.raises(SystemExit):
        train_mfu.main(["--device", "cpu", "--probes", "fwd,nope"])
