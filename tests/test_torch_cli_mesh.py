"""The train CLI under a split mesh, end to end on the CPU: ranks in
torchrun's environment (tests/test_torch_parallel.py's harness: a free
port, gloo, every wait with a timeout) run, for the layouts (data, model,
time) (1, 2, 1) and (1, 1, 2) on 2 ranks and (2, 2, 1) on 4,

1. `python -m drn_tpu_torch.train --distributed --device cpu
   --model-axis M --time-axis S --max-steps 3 --checkpoint-dir D` (the
   data axis takes the ranks left);
2. the same command to `--max-steps 5`, which resumes D's step 3;

then `evaluate.main --checkpoint-dir D/<config>/stage1` runs in one
process. The same commands without `--distributed` in one process are the
reference: the same logged steps and losses, the whole-tensor checkpoints
of steps 3 and 5 (parameters and Adam's moments) within 1e-4, and equal
eval counts.

The config is synthetic_tiny in fp32 with 16 examples (two steps an
epoch, so both runs cross an epoch's end: its eval under the split mesh
and best/), logging every step. Each rank sets `sharding.TP_MIN_WIDTH` to
32, as tests/test_torch_tensor_parallel.py's ranks do: at the default 128
the model axis would split none of synthetic_tiny's 64-wide weights.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import drn_tpu_torch.config as port_config
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import train as port_train
from drn_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_parallel import REPO, _free_port, _rank_env, _wait_all
from torch_threads import one_torch_thread  # noqa: F401

NAME = "cli_mesh_tiny"
EXAMPLES = 16  # B=8: two steps an epoch
STEPS = (3, 5)  # the first run's last step, the resumed run's
TOL = 1e-4
OVERRIDES = dict(model=dict(dtype="float32"),
                 data=dict(synthetic_examples=EXAMPLES),
                 train=dict(log_every_steps=1))

# A rank: the twin config in its registry, the split width, then the CLI.
RANK = r"""
import dataclasses, json, sys
import drn_tpu_torch.config as C
from drn_tpu_torch import train
from drn_tpu_torch.parallel import sharding

name, overrides = sys.argv[1], json.loads(sys.argv[2])
cfg = C.get_config("synthetic_tiny")
C._REGISTRY[name] = cfg.replace(name=name, **{
    s: dataclasses.replace(getattr(cfg, s), **kw)
    for s, kw in overrides.items()})
sharding.TP_MIN_WIDTH = 32
real_shard = train.shard_model


def shard_model(model, mesh):  # the layout the CLI built, and its splits
    specs = real_shard(model, mesh)
    print(json.dumps({"layout": [mesh.data_world, mesh.model_axis,
                                 mesh.time_axis],
                      "split": sum(v is not None for v in specs.values())}),
          file=sys.stderr, flush=True)
    return specs


train.shard_model = shard_model
train.main(sys.argv[3:])
"""


@pytest.fixture
def twin(monkeypatch):
    cfg = port_config.get_config("synthetic_tiny")
    cfg = cfg.replace(name=NAME, **{
        s: dataclasses.replace(getattr(cfg, s), **kw)
        for s, kw in OVERRIDES.items()})
    monkeypatch.setitem(port_config._REGISTRY, NAME, cfg)
    return cfg


def _logged(lines):
    """{step: loss} of the train lines a run printed."""
    recs = [json.loads(l) for l in lines if l.startswith("{")]
    return {r["step"]: r["loss"] for r in recs
            if r.get("tag", "").startswith("train/") and "loss" in r}


def _split_run(ckpt, layout, steps):
    """Both ranks of one CLI command, each reporting the layout it ran
    under and how many parameters it split → rank 0's {step: loss}."""
    port, world = _free_port(), layout[0] * layout[1] * layout[2]
    argv = ["--config", NAME, "--epochs", "9", "--max-steps", str(steps),
            "--checkpoint-dir", str(ckpt), "--device", "cpu",
            "--distributed", "--model-axis", str(layout[1]),
            "--time-axis", str(layout[2])]
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", RANK, NAME, json.dumps(OVERRIDES),
         *argv], cwd=REPO, env=_rank_env(r, world, port),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    done = _wait_all(procs)
    for rc, lines in done:
        assert rc == 0, "".join(lines[-30:])
        shards = [json.loads(l) for l in lines if l.startswith('{"layout"')]
        assert shards and shards[0]["layout"] == list(layout), shards
        assert (shards[0]["split"] > 0) == (layout[1] > 1), shards
    return _logged(done[0][1])


def _evaluate(ckpt, monkeypatch):
    """`evaluate.main --checkpoint-dir` of `ckpt`'s stage → its metrics."""
    got = []
    real = port_eval.evaluate
    with monkeypatch.context() as m:
        m.setattr(port_eval, "evaluate",
                  lambda *a, **k: got.append(real(*a, **k)) or got[-1])
        port_eval.main(["--config", NAME, "--checkpoint-dir",
                        str(ckpt / NAME / "stage1"), "--device", "cpu"])
    return got[-1]


def _assert_close_states(got, want, what):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_close_states(got[k], v, f"{what}/{k}")
        elif torch.is_tensor(v):
            torch.testing.assert_close(got[k], v, rtol=TOL, atol=TOL,
                                       msg=f"{what}/{k}")
        else:
            assert got[k] == v, f"{what}/{k}"


@pytest.mark.parametrize("layout", [(1, 2, 1), (1, 1, 2), (2, 2, 1)],
                         ids=["model", "time", "data_model"])
def test_a_split_cli_run_resumes_and_evaluates_as_one_process(
        layout, twin, tmp_path, monkeypatch, capsys):
    split, whole = tmp_path / "split", tmp_path / "whole"
    split_losses = {}
    for steps in STEPS:
        split_losses[steps] = _split_run(split, layout, steps)
    whole_losses = {}
    for steps in STEPS:
        capsys.readouterr()
        port_train.main(["--config", NAME, "--epochs", "9", "--max-steps",
                         str(steps), "--checkpoint-dir", str(whole),
                         "--device", "cpu"])
        whole_losses[steps] = _logged(capsys.readouterr().err.splitlines())

    # The first run logs steps 1-3; the resumed one 4 and 5 alone.
    assert [list(whole_losses[s]) for s in STEPS] == [[1, 2, 3], [4, 5]]
    for steps in STEPS:
        assert split_losses[steps].keys() == whole_losses[steps].keys()
        for step, want in whole_losses[steps].items():
            np.testing.assert_allclose(split_losses[steps][step], want,
                                       rtol=TOL, err_msg=f"loss {step}")

    stage = lambda d: str(d / NAME / "stage1")  # noqa: E731
    for steps in STEPS:
        got = CheckpointManager(stage(split)).restore(steps)
        want = CheckpointManager(stage(whole)).restore(steps)
        assert got["step"] == want["step"] == steps
        _assert_close_states(got["model"], want["model"], f"{steps}/model")
        _assert_close_states(got["optimizer"], want["optimizer"],
                             f"{steps}/optimizer")
    best = lambda d: sorted(p.name for p in (d / NAME / "stage1" /  # noqa
                                             "best").glob("*.pth"))
    assert best(split) == best(whole) != []

    got, want = _evaluate(split, monkeypatch), _evaluate(whole, monkeypatch)
    assert got.keys() == want.keys() and len(got) == 7
    n = EXAMPLES  # the test split's examples: R@n counts = value · n / 100
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)
        if k.startswith("R@"):
            assert round(got[k] * n / 100) == round(want[k] * n / 100), k
