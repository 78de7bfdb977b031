"""Checkpoint directories in the port's CLIs, held against the same weights
read from a `.pth` and against the JAX package.

A port-trained directory (synthetic_tiny, fp32, 16 examples: 2 steps an
epoch; a best-on-val checkpoint at step 2, the latest at step 5) is read
by evaluate, infer, serve and export through `--checkpoint-dir`; each
equals its `--torch-checkpoint` run on the file the directory resolves to
(bit-equal: the same weights through the same code). Then the config
check and its flag, the refusals (a missing directory, an Orbax one), the
best-checkpoint quarantine (twins of tests/test_best_checkpoint.py), and
an Orbax round trip: `drn_tpu.train` writes 3 steps and a best,
tools/orbax_to_pth.py converts them, and the port's `evaluate --checkpoint-dir` equals
`drn_tpu.evaluate --checkpoint-dir` in fp32 to 1e-4, with equal R@n
counts.
"""

import dataclasses
import importlib.util
import json
import os
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import drn_tpu.config as jax_config
import drn_tpu.evaluate as jax_evaluate
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import export, infer, serve
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.utils.checkpoint import (BestCheckpointTracker,
                                            CheckpointManager,
                                            OrbaxCheckpointError,
                                            load_model_state,
                                            prefer_best_dir)

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = 16  # batch 8: two steps an epoch
BEST_STEP, LAST_STEP = 2, 5


def _float32(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port-trained stage-1 directory: steps 3, 4, 5 and best/2.pth (the
    first epoch's metric is the best; the second's is lower)."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = _trained_config("synthetic_tiny")
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(root),
                                  checkpoint_every_steps=1, num_epochs=9,
                                  eval_every_epochs=1))
    port_train.train(cfg, device="cpu", max_steps=LAST_STEP,
                     eval_fn=lambda model, epoch: 2.0 - epoch)
    d = root / cfg.name / "stage1"
    assert sorted(p.name for p in d.iterdir()) == [
        "3.pth", "4.pth", "5.pth", "best", "experiment_config.json"]
    assert [p.name for p in (d / "best").iterdir()] == [f"{BEST_STEP}.pth"]
    return dict(cfg=cfg, dir=str(d), best=str(d / "best" / f"{BEST_STEP}.pth"),
                last=str(d / f"{LAST_STEP}.pth"))


def _trained_config(name, get=get_config):
    """synthetic_tiny in fp32 with EXAMPLES examples a split: the config
    the directory was trained under."""
    cfg = _float32(get(name))
    return cfg.replace(data=dataclasses.replace(
        cfg.data, synthetic_examples=EXAMPLES))


@pytest.fixture
def float32_cli(monkeypatch):
    """The CLIs read the config the directory was trained under."""
    monkeypatch.setattr(port_eval, "get_config", _trained_config)
    import drn_tpu_torch.config as port_config

    real = port_config.get_config
    monkeypatch.setattr(port_config, "get_config",
                        lambda name: _trained_config(name, real))


def _evaluate(capsys, *argv):
    port_eval.main(["--config", "synthetic_tiny", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 7
    return out


@pytest.mark.parametrize("latest", [False, True])
def test_evaluate_reads_the_directory(trained, float32_cli, capsys, latest):
    """`best/` unless --latest-checkpoint; the same printout as the
    `.pth` the directory resolves to."""
    flag = ["--latest-checkpoint"] if latest else []
    got = _evaluate(capsys, "--checkpoint-dir", trained["dir"], *flag)
    want = _evaluate(capsys, "--torch-checkpoint",
                     trained["last" if latest else "best"])
    assert got == want
    best, last = (torch.load(trained[k], weights_only=True)["model"]
                  for k in ("best", "last"))
    assert not all(torch.equal(best[k], last[k]) for k in best)


def test_infer_reads_the_directory(trained, float32_cli, tmp_path, capsys):
    feats = tmp_path / "vid.npy"
    np.save(feats, np.random.default_rng(0).normal(size=(40, 128))
            .astype(np.float32))
    base = ["--config", "synthetic_tiny", "--device", "cpu", "--features",
            str(feats), "--duration", "20", "--query", "a person opens it",
            "--query", "then sits"]
    infer.main(base + ["--checkpoint-dir", trained["dir"]])
    got = capsys.readouterr().out
    infer.main(base + ["--torch-checkpoint", trained["best"]])
    assert got == capsys.readouterr().out and "score=" in got


def test_serve_reads_the_directory(trained):
    cfg = _float32(get_config("synthetic_tiny"))
    kw = dict(batch_size=4, top=3, device="cpu")
    from_dir = serve.build_service(cfg, checkpoint_dir=trained["dir"], **kw)
    from_pth = serve.build_service(cfg, torch_checkpoint=trained["best"],
                                   **kw)
    rng = np.random.default_rng(1)
    reqs = [{"query": q, "features": rng.normal(size=(t, 128)).tolist(),
             "duration": 15.0}
            for q, t in (("the door opens", 30), ("a man sits", 7))]
    got = from_dir._run([from_dir.prepare(r) for r in reqs])
    assert got == from_pth._run([from_pth.prepare(r) for r in reqs])
    assert all(a["segments"] for a in got)
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve.build_service(cfg, checkpoint_dir=trained["dir"],
                            torch_checkpoint=trained["best"], **kw)


def test_export_reads_the_latest_step(trained, float32_cli, tmp_path,
                                      capsys):
    """export takes the latest step, not best/, as the JAX exporter does."""
    out = str(tmp_path / "drn.pt2")
    export.main(["--config", "synthetic_tiny", "--device", "cpu",
                 "--batch-size", "4", "--checkpoint-dir", trained["dir"],
                 "--out", out])
    capsys.readouterr()
    call, _ = export.load_exported(out)
    cfg = _float32(get_config("synthetic_tiny"))
    rng = np.random.default_rng(2)
    spec = export.batch_spec(cfg, 4)
    batch = {"features": rng.normal(size=spec["features"].shape)
             .astype(np.float32),
             "word_ids": rng.integers(2, 100, spec["word_ids"].shape)
             .astype(np.int32),
             "query_mask": np.ones(spec["query_mask"].shape, bool),
             "gt_grid": np.tile(np.float32([[3.0, 9.0]]), (4, 1)),
             "duration": np.full((4,), 30.0, np.float32),
             "valid": np.ones((4,), bool)}
    got = call(None, batch)
    for path, same in ((trained["last"], True), (trained["best"], False)):
        want = call(torch.load(path, weights_only=True)["model"], batch)
        assert torch.equal(got["scores"], want["scores"]) is same


def _write_config(directory, cfg, **model):
    saved = dataclasses.asdict(cfg)
    saved["model"].update(model)
    with open(os.path.join(directory, "experiment_config.json"), "w") as f:
        json.dump({"name": cfg.name, **saved}, f)


def test_config_mismatch_and_its_flag(trained, float32_cli, tmp_path,
                                      capsys):
    """A directory trained under another parity-relevant config is refused
    by evaluate, infer and serve; --allow-config-mismatch warns and reads
    it."""
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / f"{LAST_STEP}.pth").write_bytes(Path(trained["last"]).read_bytes())
    _write_config(d, trained["cfg"], level_ranges=[[0.0, 0.1], [0.1, 3.0]])
    with pytest.raises(ValueError, match="parity-relevant config"):
        _evaluate(capsys, "--checkpoint-dir", str(d))
    with pytest.raises(ValueError, match="parity-relevant config"):
        serve.build_service(_float32(get_config("synthetic_tiny")),
                            checkpoint_dir=str(d), device="cpu")
    feats = tmp_path / "vid.npy"
    np.save(feats, np.ones((8, 128), np.float32))
    argv = ["--config", "synthetic_tiny", "--device", "cpu", "--features",
            str(feats), "--query", "x", "--checkpoint-dir", str(d)]
    with pytest.raises(ValueError, match="parity-relevant config"):
        infer.main(argv)
    with pytest.warns(UserWarning, match="level_ranges"):
        got = _evaluate(capsys, "--checkpoint-dir", str(d),
                        "--allow-config-mismatch")
    assert got == _evaluate(capsys, "--torch-checkpoint", trained["last"])
    with pytest.warns(UserWarning, match="level_ranges"):
        infer.main(argv + ["--allow-config-mismatch"])
    assert "score=" in capsys.readouterr().out


def test_missing_empty_and_orbax_directories(trained, tmp_path):
    cfg = _float32(get_config("synthetic_tiny"))
    for d in (tmp_path / "missing", tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint in"):
            port_eval.main(["--config", "synthetic_tiny", "--device", "cpu",
                            "--checkpoint-dir", str(d)])
    orbax = tmp_path / "orbax"
    (orbax / "12" / "default").mkdir(parents=True)
    for call in (lambda: serve.build_service(cfg, checkpoint_dir=str(orbax),
                                             device="cpu"),
                 lambda: export.main(["--device", "cpu", "--config",
                                      "synthetic_tiny", "--out", "x.pt2",
                                      "--checkpoint-dir", str(orbax)])):
        with pytest.raises(OrbaxCheckpointError,
                           match=re.escape("python tools/orbax_to_pth.py")):
            call()
    with pytest.raises(SystemExit):  # exactly one parameter source
        port_eval.main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        port_eval.main(["--device", "cpu", "--checkpoint-dir", trained["dir"],
                        "--torch-checkpoint", trained["last"]])


def test_restore_a_given_step(trained):
    """A given step, whole or its params alone; a step not kept raises."""
    whole = CheckpointManager(trained["dir"]).restore(4)
    assert set(whole) == {"model", "optimizer", "step"} and whole["step"] == 4
    params = load_model_state(trained["dir"], 4)
    assert params.keys() == whole["model"].keys()
    assert all(torch.equal(params[k], v) for k, v in whole["model"].items())
    with pytest.raises(FileNotFoundError, match="no step 2 in"):
        load_model_state(trained["dir"], 2)


def test_a_step_without_optimizer_state(trained, tmp_path):
    """What the converter writes ({"model", "step"}) serves --init-from;
    a resume from it raises instead of restarting Adam."""
    d = tmp_path / trained["cfg"].name / "stage1"
    d.mkdir(parents=True)
    state = torch.load(trained["last"], weights_only=True)
    torch.save({"model": state["model"], "step": LAST_STEP},
               d / f"{LAST_STEP}.pth")
    cfg = trained["cfg"].replace(train=dataclasses.replace(
        trained["cfg"].train, checkpoint_dir=str(tmp_path),
        eval_every_epochs=0))
    with pytest.raises(ValueError, match="no optimizer state"):
        port_train.train(cfg, device="cpu", max_steps=LAST_STEP + 1)
    stage2 = cfg.replace(train=dataclasses.replace(cfg.train, stage=2))
    model = port_train.train(stage2, device="cpu", max_steps=1,
                             init_from=str(d))
    for k, v in state["model"].items():  # the stage-2 freeze kept them
        if model.owner(k) != "iou_head":
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0,
                                       atol=0, msg=k)


# --- the best-checkpoint quarantine (twins of tests/test_best_checkpoint.py)

def _sd(v=0.0):
    return {"w": torch.full((4,), v)}


def test_tracker_survives_corrupt_best_dir(tmp_path):
    """An unreadable best is moved aside to best.corrupt-N, so readers
    never pick it; the next evaluation re-anchors the best."""
    d = str(tmp_path / "ckpt")
    best = tmp_path / "ckpt" / "best"
    best.mkdir(parents=True)
    (best / "7.pth").write_bytes(b"\x00not-a-checkpoint")
    assert prefer_best_dir(d) == str(best)
    with pytest.warns(UserWarning, match="best-checkpoint metric restore"):
        tr = BestCheckpointTracker(d)
    assert tr.best_metric is None
    assert (tmp_path / "ckpt" / "best.corrupt-0" / "7.pth").exists()
    assert prefer_best_dir(d) == d  # the empty best/ is not preferred
    assert tr.update(8, _sd(), 1.0)
    assert BestCheckpointTracker(d).best_metric == 1.0

    # an older schema without val_metric
    d2 = tmp_path / "ckpt2"
    (d2 / "best").mkdir(parents=True)
    torch.save({"model": _sd(), "step": 3}, d2 / "best" / "3.pth")
    with pytest.warns(UserWarning, match="best-checkpoint metric restore"):
        tr2 = BestCheckpointTracker(str(d2))
    assert tr2.best_metric is None
    assert (d2 / "best.corrupt-0" / "3.pth").exists()
    assert tr2.update(4, _sd(), 2.0)
    assert BestCheckpointTracker(str(d2)).best_metric == 2.0


def test_tracker_rejects_non_finite_metrics(tmp_path):
    tr = BestCheckpointTracker(str(tmp_path))
    assert tr.update(1, _sd(1), 0.45)
    assert not tr.update(2, _sd(2), float("nan"))
    assert tr.best_metric == 0.45
    assert not tr.update(3, _sd(3), 0.30)
    assert tr.update(4, _sd(4), 0.50)
    assert not tr.update(5, _sd(5), float("inf"))
    assert [p.name for p in (tmp_path / "best").iterdir()] == ["4.pth"]


def test_quarantine_tolerates_losing_the_rename_race(tmp_path, monkeypatch):
    """Processes sharing a directory can quarantine at once: a rename
    whose source a peer moved reports the peer's target; a taken target
    moves on to the next N."""
    d = str(tmp_path / "ckpt")
    (tmp_path / "ckpt" / "best").mkdir(parents=True)
    (tmp_path / "ckpt" / "best" / "7.pth").write_bytes(b"\x00garbage")
    real_rename = os.rename
    calls = {"n": 0}

    def racing_rename(src, dst):
        if calls["n"] == 0 and dst.endswith(".corrupt-0"):
            calls["n"] += 1
            real_rename(src, dst)  # the peer moves it...
            raise FileNotFoundError(src)  # ...and this process loses
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", racing_rename)
    with pytest.warns(UserWarning,
                      match="best-checkpoint metric restore") as rec:
        tr = BestCheckpointTracker(d)
    assert "best.corrupt-0" in "\n".join(str(w.message) for w in rec)
    assert tr.best_metric is None and tr.update(8, _sd(), 1.0)
    assert (tmp_path / "ckpt" / "best.corrupt-0" / "7.pth").exists()

    d2 = tmp_path / "ckpt2"
    (d2 / "best").mkdir(parents=True)
    (d2 / "best" / "3.pth").write_bytes(b"\x00garbage")
    (d2 / "best.corrupt-0").mkdir()
    with pytest.warns(UserWarning, match="best-checkpoint metric restore"):
        BestCheckpointTracker(str(d2))
    assert (d2 / "best.corrupt-1" / "3.pth").exists()


def test_valid_best_and_stray_files_are_not_quarantined(tmp_path):
    """A readable best keeps its metric; a temporary file left by a save
    that was killed is no step, so it is no corruption either."""
    tr = BestCheckpointTracker(str(tmp_path))
    assert tr.update(5, _sd(), 42.0)
    (tmp_path / "best" / "6.pth.tmp.123").write_bytes(b"\x00partial")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = BestCheckpointTracker(str(tmp_path))
    assert again.best_metric == 42.0
    assert not (tmp_path / "best.corrupt-0").exists()
    assert prefer_best_dir(str(tmp_path)) == str(tmp_path / "best")


# --- Orbax → .pth --------------------------------------------------------

def _converter():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_pth", REPO / "tools" / "orbax_to_pth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_round_trip(tmp_path, monkeypatch, capsys):
    """drn_tpu.train writes 3 steps and a best-on-val checkpoint at step
    2; the converter writes the port's directory; both evaluators read
    their directory (its best/) to the same numbers."""
    from drn_tpu.train import train as jax_train

    jcfg = _float32(jax_config.get_config("synthetic_tiny"))
    jcfg = jcfg.replace(
        data=dataclasses.replace(jcfg.data, synthetic_examples=EXAMPLES),
        train=dataclasses.replace(jcfg.train, checkpoint_dir=str(tmp_path),
                                  eval_every_epochs=1))
    jax_train(jcfg, max_steps=3, eval_fn=lambda state, epoch: 1.0)
    src = tmp_path / "synthetic_tiny" / "stage1"
    out = tmp_path / "converted"
    _converter().main(["--config", "synthetic_tiny", "--checkpoint-dir",
                       str(src), "--out", str(out)])
    assert "wrote" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == [
        "3.pth", "best", "experiment_config.json"]
    assert set(torch.load(out / "3.pth", weights_only=True)) == {"model",
                                                                 "step"}
    best = torch.load(out / "best" / "2.pth", weights_only=True)
    assert (best["step"], best["val_metric"]) == (2, 1.0)
    assert prefer_best_dir(str(out)) == str(out / "best")

    pcfg = _trained_config("synthetic_tiny")
    results = {}
    for name, mod, cfg, d in (("jax", jax_evaluate, jcfg, src),
                              ("port", port_eval, pcfg, out)):
        monkeypatch.setattr(mod, "get_config", lambda n, c=cfg: c)
        real = mod.evaluate
        monkeypatch.setattr(mod, "evaluate", lambda *a, _r=real, _n=name,
                            **k: results.setdefault(_n, _r(*a, **k)))
        argv = ["--config", "synthetic_tiny", "--checkpoint-dir", str(d)]
        mod.main(argv + (["--device", "cpu"] if name == "port" else []))
    capsys.readouterr()
    want, got = results["jax"], results["port"]
    assert got.keys() == want.keys() and len(got) == 7
    n = EXAMPLES  # the test split's examples: R@n counts = value · n / 100
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        if k.startswith("R@"):
            assert round(got[k] * n / 100) == round(want[k] * n / 100), k
