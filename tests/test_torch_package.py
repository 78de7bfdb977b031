"""The port as a package: its config equals the JAX package's, it imports
nothing of JAX nor of `drn_tpu`, and its entry points refuse to run on the
CPU unless asked to."""

import dataclasses
import datetime
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import drn_tpu.config as jax_config
import drn_tpu_torch.config as port_config
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch.parallel import make_mesh

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "drn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
PORT_SCRIPTS = sorted((ROOT / "drn_tpu_torch" / "scripts").glob("*.sh"))


@pytest.mark.parametrize("name", jax_config.list_configs())
def test_config_registry_equals_jax(name):
    assert port_config.list_configs() == jax_config.list_configs()
    assert dataclasses.asdict(port_config.get_config(name)) == \
        dataclasses.asdict(jax_config.get_config(name))


def test_config_dataclasses_equal_jax():
    for cls in ("ModelConfig", "DataConfig", "TrainConfig", "EvalConfig",
                "MeshConfig", "ExperimentConfig"):
        assert dataclasses.asdict(getattr(port_config, cls)()) == \
            dataclasses.asdict(getattr(jax_config, cls)()), cls


# Every module of the port: the scan below must reach each one.
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__") for p in (ROOT / "drn_tpu_torch").rglob("*.py"))


def test_port_imports_no_jax_and_nothing_of_drn_tpu():
    """Import every port module and chip_smoke in a fresh interpreter;
    no jax/flax/optax/orbax or drn_tpu module may be loaded, and every
    module of the port (the native reader's binding, infer, the data
    layer, serve, export and their probes included) must have been
    imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import drn_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(drn_tpu_torch.__path__, "
        "'drn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'drn_tpu'))\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('drn_tpu_torch')))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, bad = out.stdout.strip().splitlines()
    assert bad == "[]", bad
    assert not set(PORT_MODULES) - set(loaded.split()), \
        set(PORT_MODULES) - set(loaded.split())
    assert {"drn_tpu_torch.native", "drn_tpu_torch.infer",
            "drn_tpu_torch.data.validate", "drn_tpu_torch.data.staging",
            "drn_tpu_torch.data.datasets", "drn_tpu_torch.data.features",
            "drn_tpu_torch.data.vocab", "drn_tpu_torch.serve",
            "drn_tpu_torch.export", "drn_tpu_torch.probes.serve_load",
            "drn_tpu_torch.probes.export_roundtrip", "drn_tpu_torch.bench",
            "drn_tpu_torch.probes.host_pipeline",
            "drn_tpu_torch.probes.staged_eval",
            "drn_tpu_torch.probes.train_probe",
            "drn_tpu_torch.probes.train_mfu"} <= set(PORT_MODULES)


@pytest.mark.parametrize("path", PORT_SOURCES + PORT_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_names_no_jax_nor_drn_tpu(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)"
                         r"\b", text, re.M)
    # `drn_tpu_torch` itself starts with `drn_tpu`: match only the name
    # that is not followed by `_torch`.
    assert not re.search(r"\bdrn_tpu\.", text)
    assert not re.search(r"^\s*(import|from)\s+drn_tpu\b(?!_)", text, re.M)
    if path.suffix == ".sh":  # the recipe scripts run the port's CLIs only
        assert not re.search(r"\bjax", text)
        modules = re.findall(r"python\s+-m\s+(\S+)", text)
        assert modules and all(m.startswith("drn_tpu_torch.")
                               for m in modules), modules


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(no_cuda, tmp_path):
    from drn_tpu_torch import bench, infer, train
    from drn_tpu_torch.probes import (host_pipeline, staged_eval, train_mfu,
                                      train_probe)

    cfg = port_config.get_config("synthetic_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--config", "synthetic_tiny", "--torch-checkpoint",
                    "m.pth", "--features", "v.npy", "--query", "x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.build_model(cfg)
    model = port_eval.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.evaluate(cfg, model)
    batch = {"features": np.zeros((2, 32, 128), np.float32),
             "word_ids": np.ones((2, 8), np.int32),
             "query_mask": np.ones((2, 8), bool)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.predict(cfg, model, batch)
    segs, keep, scores = port_eval.predict(cfg, model, batch, device="cpu")
    assert segs.shape == (2, cfg.eval.top_k, 2) and keep.dtype == bool
    assert np.isfinite(scores).all()
    # The bench and the probes refuse before they write or time anything.
    out = ["--out", str(tmp_path / "corpus")]
    for main, argv in ((bench.main, ["--config", "synthetic_tiny"]),
                       (bench.main, ["--all-configs"]),
                       (host_pipeline.main, out),
                       (staged_eval.main, out),
                       (train_probe.main, ["--config", "synthetic_tiny"]),
                       (train_mfu.main, ["--config", "synthetic_tiny"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not (tmp_path / "corpus").exists()


def test_evaluate_on_the_cpu_when_asked():
    cfg = port_config.get_config("synthetic_tiny")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               synthetic_examples=12))
    model = port_eval.build_model(cfg, device="cpu")
    res = port_eval.evaluate(cfg, model, device="cpu")
    assert set(res) == {"mIoU", "R@1,IoU=0.3", "R@1,IoU=0.5", "R@1,IoU=0.7",
                        "R@5,IoU=0.3", "R@5,IoU=0.5", "R@5,IoU=0.7"}
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in res.values())


def test_out_of_scope_options_raise(tmp_path):
    """Refused rather than ignored: staging the synthetic fixture (it has
    no feature files) and a real dataset without its annotation files
    raise, as do a missing checkpoint directory and an Orbax one (naming
    its converter). Worker processes and a mesh are in scope: the same
    metrics as in process, the mesh's from a gloo group of this process
    alone (its counts all-reduced; two ranks: tests/test_torch_parallel.py)."""
    cfg = port_config.get_config("synthetic_tiny")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               synthetic_examples=12))
    model = port_eval.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="synthetic"):
        port_eval.evaluate(cfg, model, device="cpu", device_features=True)
    want = port_eval.evaluate(cfg, model, device="cpu")
    assert port_eval.evaluate(cfg.replace(data=dataclasses.replace(
        cfg.data, num_workers=2)), model, device="cpu") == want
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        assert port_eval.evaluate(cfg, model, device="cpu",
                                  mesh=make_mesh()) == want
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(FileNotFoundError, match="annotation file"):
        port_eval.evaluate(port_config.get_config("charades_c3d"), model,
                           device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint in"):
        port_eval.main(["--config", "synthetic_tiny", "--checkpoint-dir",
                        str(tmp_path / "ckpt"), "--device", "cpu"])
    (tmp_path / "orbax" / "7" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax.*tools/orbax_to_pth.py"):
        port_eval.main(["--config", "synthetic_tiny", "--checkpoint-dir",
                        str(tmp_path / "orbax"), "--device", "cpu"])


def test_main_evaluates_a_parity_checkpoint(tmp_path, capsys):
    cfg = port_config.get_config("synthetic_tiny")
    model = port_eval.build_model(cfg, device="cpu", seed=3)
    path = tmp_path / "m.pth"
    torch.save({"model": model.state_dict()}, path)
    port_eval.main(["--config", "synthetic_tiny", "--torch-checkpoint",
                    str(path), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 7 and lines[0].startswith("mIoU: ")
