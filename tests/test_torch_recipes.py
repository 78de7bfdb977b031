"""The recipe chain the shell scripts run, through both packages' `main`s,
held number for number: the port's twin of tests/test_cli_end_to_end.py
and tests/test_dataset_families_end_to_end.py, which check only that
0 <= R@n <= 100.

For the smoke (`scripts/smoke_synthetic.sh` at synthetic_tiny) and for
each dataset family on disk (Charades-STA's `.npy` directory, ActivityNet's
nested `.h5`, TACoS's flat `.h5`; 6 videos written from a numpy seed):

1. `drn_tpu.train.main` stage 1;
2. `tools/orbax_to_pth.py` converts its directory;
3. both packages' stage 2 `main` with `--init-from` their stage-1 directory;
4. both packages' `evaluate.main --checkpoint-dir` of their stage 2.

The configs are fp32 twins registered in both registries, logging every
step. The stage-2 losses agree at every logged step within 1e-4 relative,
the 7 metrics within 1e-4 with equal R@n counts, and stage 2 leaves every
tensor outside the IoU head bit-equal (stage2_iou_only is the default).
Both in-process iterators yield the same batches at num_workers=0.

Then the port's smoke script runs as users run it (DEVICE=cpu), and the
four scripts are held to the JAX package's as twins: both run with a stub
`python` that records its arguments, and the recorded commands are equal
once `drn_tpu` is mapped to `drn_tpu_torch` and `--device` dropped.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import drn_tpu.config as jax_config
import drn_tpu.evaluate as jax_evaluate
import drn_tpu.train as jax_train
import drn_tpu_torch.config as port_config
from drn_tpu_torch import evaluate as port_evaluate
from drn_tpu_torch import train as port_train
from drn_tpu_torch.data.pipeline import make_dataset
from drn_tpu_torch.utils.checkpoint import load_model_state, prefer_best_dir

from torch_threads import child_env, one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ("smoke_synthetic", "train_charades_c3d", "train_activitynet",
           "train_tacos")
# (stage-1 steps, stage-2 steps) of each chain: the smoke script's, and
# tests/test_dataset_families_end_to_end.py's for the families.
STEPS = {"smoke": (10, 5), "charades": (2, 2), "activitynet": (2, 2),
         "tacos": (2, 2)}
LOSS_RTOL = METRIC_ATOL = 1e-4


def _twin(mod, family):
    """The fp32 config of `family` in package `mod`'s registry, logging
    every step: synthetic_tiny itself for the smoke; for a family its
    widths with the tests' data (feature_dim 32, num_clips 32, C3D)."""
    tiny = mod.get_config("synthetic_tiny")
    data = {} if family == "smoke" else dict(
        dataset=family, feature_type="c3d", num_clips=32,
        **({"feature_fps": 2.0} if family == "charades" else {}))
    return tiny.replace(
        name=f"recipes_{family}",
        model=dataclasses.replace(
            tiny.model, dtype="float32",
            **({} if family == "smoke" else {"feature_dim": 32})),
        data=dataclasses.replace(tiny.data, **data),
        train=dataclasses.replace(tiny.train, log_every_steps=1))


def _write_charades(root, rng):
    """tests/test_cli_end_to_end.py's corpus: one .npy a video."""
    feat = root / "feats"
    feat.mkdir()
    lines = {"train": [], "test": []}
    for v in range(6):
        rows = int(rng.integers(40, 90))
        np.save(feat / f"VID{v:02d}.npy",
                rng.normal(size=(rows, 32)).astype(np.float32))
        dur = rows / 2.0
        for split in lines:
            s = float(rng.uniform(0, dur * 0.6))
            e = float(rng.uniform(s + 1.0, dur))
            lines[split].append(
                f"VID{v:02d} {s:.1f} {e:.1f}##person does activity {v}.")
    for split, ls in lines.items():
        (root / f"charades_sta_{split}.txt").write_text("\n".join(ls) + "\n")
    return feat, root / "charades_sta_{split}.txt"


def _write_activitynet(root, rng):
    """The public release's nesting: a group a video, its dataset inside."""
    path, ann = root / "anet_c3d.hdf5", {}
    with h5py.File(path, "w") as f:
        for v in range(6):
            vid, rows = f"v_test{v:03d}", int(rng.integers(40, 90))
            f.create_group(vid).create_dataset(
                "c3d_features",
                data=rng.normal(size=(rows, 32)).astype(np.float32))
            dur, ts, sents = rows / 2.0, [], []
            for q in range(2):
                s = float(rng.uniform(0, dur * 0.6))
                ts.append([s, float(rng.uniform(s + 1.0, dur))])
                sents.append(f"someone performs action {v} {q}.")
            ann[vid] = {"duration": dur, "timestamps": ts,
                        "sentences": sents}
    for split in ("train", "test"):
        (root / f"anet_{split}.json").write_text(json.dumps(ann))
    return path, root / "anet_{split}.json"


def _write_tacos(root, rng):
    """A flat archive (a dataset a bare video id); annotations keyed by
    "<vid>.avi" in frame units."""
    path, ann = root / "tacos_c3d.h5", {}
    with h5py.File(path, "w") as f:
        for v in range(6):
            vid, rows = f"s13-d{v:02d}", int(rng.integers(40, 90))
            f.create_dataset(
                vid, data=rng.normal(size=(rows, 32)).astype(np.float32))
            num_frames, ts, sents = rows * 30, [], []
            for q in range(2):
                sf = int(rng.integers(0, num_frames // 2))
                ts.append([sf, int(rng.integers(sf + 30, num_frames))])
                sents.append(f"the person chops ingredient {v} {q}.")
            ann[vid + ".avi"] = {"fps": 29.4, "num_frames": num_frames,
                                 "timestamps": ts, "sentences": sents}
    for split in ("train", "test"):
        (root / f"tacos_{split}.json").write_text(json.dumps(ann))
    return path, root / "tacos_{split}.json"


WRITERS = {"charades": _write_charades, "activitynet": _write_activitynet,
           "tacos": _write_tacos}


def _converter():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_pth", REPO / "tools" / "orbax_to_pth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stage2_losses(err, name):
    """{step: loss} of the stage-2 lines a run logged on stderr."""
    tag = f"train/{name}/stage2"
    recs = [json.loads(l) for l in err.splitlines() if l.startswith("{")]
    return {r["step"]: r["loss"] for r in recs
            if r.get("tag") == tag and "loss" in r}


@pytest.mark.parametrize("family", list(STEPS))
def test_the_recipe_chain_matches_jax(family, tmp_path, monkeypatch, capsys):
    name = f"recipes_{family}"
    jcfg, pcfg = _twin(jax_config, family), _twin(port_config, family)
    monkeypatch.setitem(jax_config._REGISTRY, name, jcfg)
    monkeypatch.setitem(port_config._REGISTRY, name, pcfg)
    data, data_cfg = [], pcfg.data
    if family != "smoke":
        feat, ann = WRITERS[family](tmp_path, np.random.default_rng(0))
        data = ["--feature-dir", str(feat), "--annotation-path", str(ann)]
        data_cfg = dataclasses.replace(data_cfg, feature_dir=str(feat),
                                       annotation_path=str(ann))
    steps1, steps2 = STEPS[family]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    stage1 = jdir / name / "stage1"
    port_stage1 = pdir / name / "stage1"
    cpu = ["--device", "cpu"]

    jax_train.main(["--config", name, "--stage", "1", "--max-steps",
                    str(steps1), "--checkpoint-dir", str(jdir), *data])
    _converter().main(["--config", name, "--checkpoint-dir", str(stage1),
                       "--out", str(port_stage1)])
    capsys.readouterr()
    stage2 = ["--config", name, "--stage", "2", "--max-steps", str(steps2),
              *data]
    jax_train.main([*stage2, "--checkpoint-dir", str(jdir), "--init-from",
                    str(stage1)])
    want_losses = _stage2_losses(capsys.readouterr().err, name)
    port_train.main([*stage2, "--checkpoint-dir", str(pdir), "--init-from",
                     str(port_stage1), *cpu])
    got_losses = _stage2_losses(capsys.readouterr().err, name)
    assert list(want_losses) == list(range(1, steps2 + 1)), want_losses
    assert got_losses.keys() == want_losses.keys(), (got_losses, want_losses)
    for step, want in want_losses.items():
        np.testing.assert_allclose(got_losses[step], want, rtol=LOSS_RTOL,
                                   err_msg=f"stage-2 loss at step {step}")

    results = {}
    for key, mod, d, extra in (
            ("jax", jax_evaluate, jdir, []), ("port", port_evaluate, pdir,
                                              cpu)):
        real = mod.evaluate
        monkeypatch.setattr(mod, "evaluate", lambda *a, _r=real, _k=key,
                            **k: results.setdefault(_k, _r(*a, **k)))
        mod.main(["--config", name, "--checkpoint-dir",
                  str(d / name / "stage2"), *data, *extra])
    printed = capsys.readouterr().out
    want, got = results["jax"], results["port"]
    assert got.keys() == want.keys() and len(got) == 7, (got, want)
    n = len(make_dataset(data_cfg, pcfg.model, split="test"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=METRIC_ATOL,
                                   err_msg=k)
        if k.startswith("R@"):  # R@n counts = value · n / 100
            assert round(got[k] * n / 100) == round(want[k] * n / 100), k
    assert len(re.findall(r"^R@\d,IoU=[\d.]+: ", printed, re.M)) == 12

    # Stage 2 trained the IoU head alone: the port's last stage-2 step
    # holds the stage-1 checkpoint it started from everywhere else.
    start = load_model_state(prefer_best_dir(str(port_stage1)))
    end = load_model_state(str(pdir / name / "stage2"))
    model = port_evaluate.build_model(pcfg, device="cpu")
    assert start.keys() == end.keys()
    moved = {model.owner(k) for k in start if not torch.equal(start[k],
                                                               end[k])}
    assert moved == {"iou_head"}, moved


def test_the_smoke_script_runs_on_the_cpu(tmp_path):
    """drn_tpu_torch/scripts/smoke_synthetic.sh as users run it, with
    DEVICE=cpu: three CLI processes, rc 0, `smoke ok`."""
    out = subprocess.run(
        ["bash", "drn_tpu_torch/scripts/smoke_synthetic.sh"], cwd=REPO,
        env=child_env(DEVICE="cpu", TMPDIR=str(tmp_path)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "smoke ok", out.stdout
    assert "R@1,IoU=0.5:" in out.stdout


STUB = """#!/bin/sh
for a in "$@"; do printf '%s\\037' "$a"; done >> "$RECORD"
echo >> "$RECORD"
"""


def _recorded(script, env, tmp_path, tag):
    """The argument vectors `script` passes to `python`, in order, with
    the stub first on PATH; the checkpoint root (the first
    --checkpoint-dir, mktemp's in the smoke) written as $CKPT."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "python").write_text(STUB)
    (bin_dir / "python").chmod(0o755)
    record = tmp_path / f"{tag}.rec"
    run_env = {**env, "RECORD": str(record),
               "TMPDIR": str(tmp_path),
               "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    out = subprocess.run(["bash", str(script)], cwd=REPO, env=run_env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, (script, out.stderr)
    argvs = [line.split("\x1f")[:-1]
             for line in record.read_text().splitlines()]
    root = argvs[0][argvs[0].index("--checkpoint-dir") + 1]
    return [[a.replace(root, "$CKPT") for a in argv] for argv in argvs]


def _reference_script(name, tmp_path):
    """The JAX package's script as bash can run it, with the two repairs
    the port's scripts make:

    - bash ends each of the three recipe scripts' `${ANNOTATIONS:?message}`
      at the `}` of the message's `{split}`, so as committed they stop
      there (exit 127 or a syntax error) before any command: the copy
      quotes that message;
    - train_charades_c3d.sh trains in GloVe mode when GLOVE is set, but
      its final evaluate is not given the file, so it builds the hashed
      vocabulary's embedding and cannot load the checkpoint's: the copy
      passes `--glove-path` there too."""
    text = (REPO / "scripts" / f"{name}.sh").read_text()
    fixed = re.sub(r"^ANNOTATIONS=\$\{ANNOTATIONS:\?(.*)\}$",
                   r'ANNOTATIONS=${ANNOTATIONS:?"\1"}', text, flags=re.M)
    assert (fixed != text) == (name != "smoke_synthetic"), name
    if name == "train_charades_c3d":
        final = '    --checkpoint-dir "$CKPT/charades_c3d/stage2"'
        assert fixed.count(final) == 1
        fixed = fixed.replace(final, '    ${GLOVE:+--glove-path "$GLOVE"} '
                              "\\\n" + final)
    path = tmp_path / f"reference_{name}.sh"
    path.write_text(fixed)
    return path


def _drop_device(argv):
    if "--device" not in argv:
        return argv
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


@pytest.mark.parametrize("script", SCRIPTS)
def test_the_scripts_are_twins_of_the_jax_packages(script, tmp_path):
    data = {"FEATURES": "/data/features", "ANNOTATIONS": "/data/{split}.txt"}
    variants = [{}, {"DEVICE": "cpu", "CKPT": "/ckpt"}]
    if script == "train_charades_c3d":
        variants.append({"GLOVE": "/data/glove.txt", "DEVICE": "cuda:0"})
    if script == "train_activitynet":
        variants.append({"CONFIG": "activitynet_c3d", "DEVICE": "cpu"})
    for i, env in enumerate(variants):
        env = {**({} if script == "smoke_synthetic" else data), **env}
        base = {k: v for k, v in os.environ.items()
                if k not in ("DEVICE", "CKPT", "GLOVE", "CONFIG")}
        want = _recorded(_reference_script(script, tmp_path),
                         {**base, **env}, tmp_path, f"jax{i}")
        got = _recorded(REPO / "drn_tpu_torch" / "scripts" / f"{script}.sh",
                        {**base, **env}, tmp_path, f"port{i}")
        assert len(want) == 3, want
        mapped = [[re.sub(r"drn_tpu(?!_torch)", "drn_tpu_torch", a)
                   for a in argv] for argv in want]
        assert [_drop_device(a) for a in got] == mapped, (env, got, mapped)
        device = env.get("DEVICE")
        assert all(("--device" in a) == bool(device) for a in got), got
        if device:
            assert all(a[a.index("--device") + 1] == device for a in got)
