"""The port's data parallelism (drn_tpu_torch/parallel/, the trainer's and
evaluate's `mesh`) on the CPU over gloo, against the JAX package's
`train(mesh=make_mesh(n_devices=2))` and `evaluate(mesh=...)` on the
same config (synthetic_tiny in fp32) and the same initial weights.

Two ranks are launched once for the training, evaluation and checkpoint
checks: two processes with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) that import torch and the port
only, each joining the group through `init_distributed("cpu")`; the
preemption case launches the real train CLI with `--distributed` twice.
The JAX reference runs in the test process on two of conftest's virtual
CPU devices. Every wait on a child has a timeout, and the group's
collectives one of their own, so a hang fails instead of eating the
suite's time.

Tolerances, fp32: losses and parameters 1e-4, as tests/test_torch_train.py
holds one process against JAX (two ranks only reorder fp32 sums); the
ranks' parameters equal bit for bit (DDP hands every rank the same
averaged gradient); recall metrics within one query, the slack of
tests/test_multiprocess.py (a prediction whose tIoU sits at a threshold
can flip).
"""

import dataclasses
import json
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.evaluate import evaluate as jax_evaluate
from drn_tpu.models.drn import location_metadata as jax_location_metadata
from drn_tpu.models.losses import drn_loss as jax_drn_loss
from drn_tpu.parallel import make_mesh as jax_make_mesh
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu import train as jax_train_module
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.data.pipeline import (BatchIterator, WorkerBatchIterator,
                                         make_dataset)
from drn_tpu_torch.models import DRN, location_metadata
from drn_tpu_torch.models.losses import drn_loss
from drn_tpu_torch.parallel import check_axes, make_mesh, row_block
from drn_tpu_torch.utils.preemption import PREEMPTED_EXIT_CODE

from torch_threads import child_env, one_torch_thread  # noqa: F401

REPO = str(Path(__file__).resolve().parents[1])
CHILD_TIMEOUT_S = 180
# 14 examples at B=8: each epoch's second batch holds 6 rows, 4 on rank 0
# and 2 on rank 1, so the ranks' normalisers differ (the test split too).
EXAMPLES, STEPS = 14, 4
OVERRIDES = dict(model=dict(dtype="float32"),
                 data=dict(synthetic_examples=EXAMPLES),
                 train=dict(log_every_steps=1, checkpoint_every_steps=2,
                            eval_every_epochs=0))


def _apply(cfg, overrides):
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kw)
                          for sec, kw in overrides.items()})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    return child_env(RANK=str(rank), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))


def _wait_all(procs, on_line=None):
    """Stream each child's stderr (to `on_line(rank, line)`) → [(exit code,
    stderr lines)]; every child is killed after CHILD_TIMEOUT_S."""
    results = [None] * len(procs)

    def drain(i, p):
        lines = []
        for line in p.stderr:
            lines.append(line)
            if on_line:
                on_line(i, line)
        results[i] = lines

    killers = [threading.Timer(CHILD_TIMEOUT_S, p.kill) for p in procs]
    readers = [threading.Thread(target=drain, args=(i, p))
               for i, p in enumerate(procs)]
    for t in killers + readers:
        t.start()
    try:
        rcs = [p.wait(timeout=CHILD_TIMEOUT_S + 10) for p in procs]
        for t in readers:
            t.join(timeout=30)
    finally:
        for t in killers:
            t.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
    return list(zip(rcs, results))


# The module's 2-rank launch. Each rank: two training runs from the same
# initial weights (4 steps into a/; one epoch of 2 steps into b/, with its
# eval and best/), then evaluate and the eval counts over the group, its
# result in rank<r>.json. Every logged record is kept with full precision
# (rank 1 prints none).
WORKER = r"""
import dataclasses, json, sys
import torch
from drn_tpu_torch import train as T
from drn_tpu_torch.config import get_config
from drn_tpu_torch.data.pipeline import make_dataset
from drn_tpu_torch.evaluate import eval_batches, eval_counts, evaluate
from drn_tpu_torch.parallel import init_distributed, make_mesh

out, init, overrides = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
dev = init_distributed("cpu", timeout_s=120)
mesh = make_mesh()
cfg = get_config("synthetic_tiny")
cfg = cfg.replace(**{s: dataclasses.replace(getattr(cfg, s), **kw)
                     for s, kw in overrides.items()})
logged = []


class Recorder(T.MetricLogger):
    def log(self, step, metrics):
        logged.append([step, {k: float(v) for k, v in metrics.items()}])
        super().log(step, metrics)


T.MetricLogger = Recorder


def run(d, steps, **train):
    c = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=f"{out}/{d}", **train))
    return T.train(c, device="cpu", mesh=mesh, init_from=init,
                   max_steps=steps)


model = run("a", 4)
losses = [(s, m) for s, m in logged if "loss" in m]
torch.save(model.state_dict(), f"{out}/rank{mesh.rank}.pth")
run("b", None, num_epochs=1, eval_every_epochs=1)
results = evaluate(cfg, model, device="cpu", mesh=mesh)
ds = make_dataset(cfg.data, cfg.model, split="test")
counts, n = eval_counts(cfg, model, eval_batches(cfg, ds, dev, mesh), dev,
                        mesh=mesh)
with open(f"{out}/rank{mesh.rank}.json", "w") as f:
    json.dump(dict(rank=mesh.rank, world=mesh.world, losses=losses,
                   results=results, n_total=n, n_test=len(ds)), f)
"""


def _jax_config(**train):
    return _apply(jax_get_config("synthetic_tiny"),
                  {**OVERRIDES, "train": {**OVERRIDES["train"], **train}})


def _port_config(**train):
    return _apply(get_config("synthetic_tiny"),
                  {**OVERRIDES, "train": {**OVERRIDES["train"], **train}})


def _two_ranks(root):
    """The 2-rank launch and the JAX reference: {"ranks": [rank 0's
    result, rank 1's], "dir", "init", "jax": {losses, params,
    results}}."""
    cfg = _jax_config()
    # DRN.init's weights, every leaf shifted by seeded noise (as
    # tests/test_torch_train.py does): at the bare init many gradients are
    # exact zeros in one framework and fp32 noise in the other, and Adam
    # moves such an element by ±lr either way.
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32),
        jax.device_get(jax_init_params(cfg, jax_build_model(cfg),
                                       jax.random.key(cfg.train.seed))))
    init = root / "init"
    init.mkdir()
    torch.save({"model": flax_params_to_state_dict(params, cfg.model)},
               init / "0.pth")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", WORKER, str(root), str(init),
         json.dumps(OVERRIDES)], cwd=REPO, env=_rank_env(r, 2, port),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for rc, lines in _wait_all(procs):
        assert rc == 0, "".join(lines[-30:])
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(2)]
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]

    # JAX: its trainer on a 2-device data mesh, logging every step.
    jlogged = []

    class Recorder(jax_train_module.MetricLogger):
        def log(self, step, metrics):
            jlogged.append((step, {k: float(v) for k, v in metrics.items()}))
            super().log(step, metrics)

    jcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(root / "jax")))
    mesh = jax_make_mesh(n_devices=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_module, "MetricLogger", Recorder)
        mp.setattr(jax_train_module, "init_params",
                   lambda *_: jax.tree_util.tree_map(jax.numpy.asarray,
                                                     params))
        state = jax_train_module.train(jcfg, mesh=mesh, max_steps=STEPS)
    jparams = jax.device_get(state.params)
    jresults = jax_evaluate(jcfg, jax_build_model(jcfg), jparams, mesh=mesh)
    return {"ranks": ranks, "dir": root, "init": init,
            "jax": {"losses": [(s, m) for s, m in jlogged if "loss" in m],
                    "params": flax_params_to_state_dict(jparams, cfg.model),
                    "results": jresults}}


def _assert_metrics_match(got, want, n_queries):
    slack = 100.0 / n_queries + 1e-6
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= slack, (k, got[k], v)


def test_two_ranks_train_evaluate_and_checkpoint_as_jax(tmp_path,
                                                        monkeypatch, capsys):
    """One launch of two ranks (one test, so that the launch is not
    repeated on several xdist workers), three checks.

    Training: 4 steps (2 epochs, each ending on a batch whose ranks hold
    4 and 2 valid rows): the global batch's losses and metrics on both
    ranks, the same as JAX's to 1e-4, and the same parameters.

    Evaluation: equal metrics on both ranks, within one query of JAX's,
    every test query counted once.

    Checkpoints: rank 0 wrote b/ (one epoch of 2 steps, its eval and
    best/): its keys are the bare model's, one process resumes it for 2
    more steps to what 4 steps in one process give, and `evaluate
    --checkpoint-dir` reads its best/."""
    two_ranks = _two_ranks(tmp_path)
    r0, r1 = two_ranks["ranks"]
    jl = two_ranks["jax"]["losses"]
    assert [s for s, _ in r0["losses"]] == [s for s, _ in jl] == \
        list(range(1, STEPS + 1))
    assert r0["losses"] == r1["losses"]  # summed over the group
    for (step, got), (_, want) in zip(r0["losses"], jl):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step} {k}")
    ranks = [torch.load(two_ranks["dir"] / f"rank{r}.pth", weights_only=True)
             for r in range(2)]
    saved = torch.load(two_ranks["dir"] / "a" / "synthetic_tiny" / "stage1"
                       / f"{STEPS}.pth", weights_only=True)
    assert saved["step"] == STEPS
    want = two_ranks["jax"]["params"]
    for k, v in ranks[0].items():
        assert torch.equal(ranks[1][k], v), k
        assert torch.equal(saved["model"][k], v), k
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-4, msg=k)

    assert r0["results"] == r1["results"]
    assert r0["n_total"] == r1["n_total"] == r0["n_test"] == EXAMPLES
    _assert_metrics_match(r0["results"], two_ranks["jax"]["results"],
                          EXAMPLES)

    ddir = two_ranks["dir"] / "b" / "synthetic_tiny" / "stage1"
    assert sorted(p.name for p in ddir.iterdir()) == [
        "2.pth", "best", "experiment_config.json"]
    assert [p.name for p in (ddir / "best").iterdir()] == ["2.pth"]
    two = torch.load(ddir / "2.pth", weights_only=True)
    cfg = _port_config()
    want_keys = DRN(cfg.model, base_len=cfg.data.num_clips).state_dict()
    assert list(two["model"]) == list(want_keys)

    init = str(two_ranks["init"])
    resumed = port_train.train(
        cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(two_ranks["dir"] / "b"))),
        device="cpu", init_from=init, max_steps=STEPS,
        run_info=(info := {}))
    assert info == {"start_step": 2, "step": STEPS}
    straight = port_train.train(
        cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(two_ranks["dir"] / "one"))),
        device="cpu", init_from=init, max_steps=STEPS)
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(resumed.state_dict()[k], v, rtol=0,
                                   atol=1e-4, msg=k)

    monkeypatch.setattr(port_eval, "get_config", lambda name: cfg)
    capsys.readouterr()
    port_eval.main(["--config", "synthetic_tiny", "--checkpoint-dir",
                    str(ddir), "--device", "cpu"])
    printed = capsys.readouterr().out
    model = port_eval.build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(ddir / "best" / "2.pth",
                                     weights_only=True)["model"])
    want = port_eval.evaluate(cfg, model, device="cpu")
    assert printed.splitlines() == [f"{k}: {v:.2f}" for k, v in want.items()]


# --- preemption: the twin of tests/test_multiprocess.py's coordinated stop


def _spawn_cli(ckpt_dir, max_steps, port):
    return [subprocess.Popen(
        [sys.executable, "-u", "-m", "drn_tpu_torch.train", "--distributed",
         "--config", "synthetic_tiny", "--device", "cpu", "--epochs", "50",
         "--max-steps", str(max_steps), "--checkpoint-dir", str(ckpt_dir)],
        cwd=REPO, env=_rank_env(r, 2, port), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


def test_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path):
    """SIGTERM reaches rank 1 alone, after rank 0 logged step 1: both
    ranks stop at the same step, rank 0 saves it, both exit 75; the same
    command with 2 ranks resumes there."""
    ckpt = tmp_path / "ckpt"
    procs = _spawn_cli(ckpt, 100_000, _free_port())
    sent = []

    def on_line(rank, line):
        if rank == 0 and not sent and '"step": 1,' in line:
            sent.append(True)
            procs[1].send_signal(signal.SIGTERM)

    (rc0, lines0), (rc1, lines1) = _wait_all(procs, on_line)
    assert sent
    assert rc0 == rc1 == PREEMPTED_EXIT_CODE, "".join(lines0[-20:]
                                                      + lines1[-20:])
    said = [[line for line in lines if line.startswith("preempted at step")]
            for lines in (lines0, lines1)]
    assert said[0] == said[1] and len(said[0]) == 1, said
    preempted = [json.loads(line) for line in lines0 if '"preempted"' in line]
    assert len(preempted) == 1
    s = preempted[0]["step"]
    assert said[0][0].startswith(f"preempted at step {s}:")
    assert not [line for line in lines1 if line.startswith("{")]  # rank 0 logs
    stage = ckpt / "synthetic_tiny" / "stage1"
    assert torch.load(stage / f"{s}.pth", weights_only=True)["step"] == s

    # The resume logs the next logged step (every 10th), not step 1.
    target = (s // 10 + 1) * 10
    (rc0, lines0), (rc1, lines1) = _wait_all(_spawn_cli(ckpt, target,
                                                        _free_port()))
    assert rc0 == rc1 == 0, "".join(lines0[-20:] + lines1[-20:])
    logged = [json.loads(line)["step"] for line in lines0
              if line.startswith("{") and '"loss"' in line]
    assert logged == [target], (s, logged)
    assert torch.load(stage / f"{target}.pth",
                      weights_only=True)["step"] == target


# --- single process: the loss's global sums, the row blocks, the mesh


def _loss_case(seed=0):
    rng = np.random.default_rng(seed)
    cfg = _jax_config()
    pcfg = _port_config()
    locs, _, level_ids = location_metadata(pcfg.model, cfg.data.num_clips)
    b, n = 6, locs.shape[0]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    outputs = dict(d_start=f32(rng.uniform(0.2, 12.0, (b, n))),
                   d_end=f32(rng.uniform(0.2, 12.0, (b, n))),
                   match_logits=f32(rng.normal(size=(b, n)) * 2.0),
                   iou_logits=f32(rng.normal(size=(b, n))))
    a, c = rng.uniform(0, cfg.data.num_clips, size=(2, b, n))
    outputs["segments"] = f32(np.stack([np.minimum(a, c), np.maximum(a, c)],
                                       -1))
    gt = f32([[3.0, 20.0], [10.2, 10.4], [0.0, 32.0], [15.5, 16.5],
              [1.0, 5.0], [9.0, 30.0]])
    valid = np.array([True, True, True, True, True, False])
    return cfg, pcfg, outputs, gt, valid, locs, level_ids


@pytest.mark.parametrize("stage", [1, 2])
def test_drn_loss_summed_over_two_halves_is_the_whole_batch(stage):
    """Rows 0-3 and 4-5 (the second half with one valid row of two): with
    `global_sum` adding the other half's normalisers, the halves' losses,
    metrics (num_pos global) and gradients add up to JAX's whole-batch
    loss."""
    cfg, pcfg, outputs, gt, valid, locs, level_ids = _loss_case()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, stage=stage))
    pcfg = pcfg.replace(train=dataclasses.replace(pcfg.train, stage=stage))
    diff = ("d_start", "d_end", "match_logits", "iou_logits")
    jl, _, jids = jax_location_metadata(cfg.model, cfg.data.num_clips)

    def jax_fn(o):
        return jax_drn_loss(cfg.model, cfg.train, {**outputs, **o}, jl, jids,
                            jax.numpy.asarray(gt), cfg.data.num_clips,
                            jax.numpy.asarray(valid))

    (jloss, jm), jg = jax.value_and_grad(jax_fn, has_aux=True)(
        {k: jax.numpy.asarray(outputs[k]) for k in diff})

    halves = [slice(0, 4), slice(4, 6)]
    t = {k: torch.from_numpy(v).requires_grad_(k in diff)
         for k, v in outputs.items()}

    def half_loss(h, global_sum):
        return drn_loss(pcfg.model, pcfg.train,
                        {k: v[h] for k, v in t.items()},
                        locs, level_ids, torch.from_numpy(gt[h]),
                        cfg.data.num_clips, torch.from_numpy(valid[h]),
                        global_sum=global_sum)

    # What each half's calls of `global_sum` are given, in order; then
    # each call answers the sum of both halves' values.
    local = [[], []]
    for r, h in enumerate(halves):
        half_loss(h, lambda x, r=r: local[r].append(x.detach()) or x)
    assert len(local[0]) == 2  # num_pos, then the IoU head's Σw
    total, metrics = 0.0, []
    for h in halves:
        calls = iter(a + b for a, b in zip(*local))
        loss, m = half_loss(h, lambda x: next(calls))
        total = total + loss
        metrics.append(m)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jloss), rtol=1e-5)
    for k in jm:
        got = (metrics[0][k].item() if k == "num_pos"
               else sum(m[k].item() for m in metrics))
        np.testing.assert_allclose(got, float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert metrics[0]["num_pos"].item() == metrics[1]["num_pos"].item()
    for k in diff:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_rank_blocks_concatenate_to_the_global_batch():
    """13 examples at B=8 over 4 ranks (2 rows each): the last batch's 5
    rows leave rank 2 one row and rank 3 only padding. Every rank's block
    of every batch, after a mid-epoch skip too, is its slice of the padded
    global batch; `len()` is the global step count on every rank."""
    cfg = _port_config()
    ds = make_dataset(dataclasses.replace(cfg.data, synthetic_examples=13),
                      cfg.model)
    whole = BatchIterator(ds, 8, shuffle=True, seed=3)
    ranks = [BatchIterator(ds, 8, shuffle=True, seed=3, rank=r, world=4)
             for r in range(4)]
    assert {len(it) for it in ranks} == {len(whole)} == {2}
    for epoch, skip in ((0, 0), (1, 1)):
        want = list(whole.epoch(epoch, skip_batches=skip))
        got = [list(it.epoch(epoch, skip_batches=skip)) for it in ranks]
        assert len(want) == 2 - skip
        for i, batch in enumerate(want):
            for r in range(4):
                block = row_block(batch, r, 4)
                assert set(got[r][i]) == set(block)
                for k, v in block.items():
                    np.testing.assert_array_equal(got[r][i][k], v, err_msg=k)
    assert not got[3][-1]["valid"].any() and got[2][-1]["valid"].sum() == 1
    with pytest.raises(AssertionError, match="does not split"):
        BatchIterator(ds, 8, world=3)


def test_rank_workers_read_their_rows_alone():
    """With 1 worker process a rank, each rank's batches are its
    BatchIterator's, and the two ranks' concatenate to the global
    batch."""
    cfg = _port_config()
    ds = make_dataset(dataclasses.replace(cfg.data,
                                          synthetic_examples=EXAMPLES),
                      cfg.model)
    whole = list(BatchIterator(ds, 8, shuffle=True, seed=0).epoch(1))
    its = [WorkerBatchIterator(ds, 8, shuffle=True, seed=0, num_workers=1,
                               rank=r, world=2) for r in range(2)]
    try:
        for it in its:
            it.start()  # both pools spawn at once
        got = [list(it.epoch(1)) for it in its]
    finally:
        for it in its:
            it.close()
    assert [len(g) for g in got] == [len(whole)] * 2
    for i, batch in enumerate(whole):
        for k, v in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([got[0][i][k], got[1][i][k]]), v, err_msg=k)


def test_the_mesh_refuses_layouts_it_cannot_split():
    """What `check_axes` still refuses: an axis below 1, a world that
    model · time does not divide, a clip grid whose time blocks are not
    even at every level but the last; and the axes outside a process
    group."""
    with pytest.raises(ValueError, match="at least 1"):
        check_axes(0, 1)
    with pytest.raises(ValueError, match="does not divide"):
        check_axes(2, 1, world=3)
    with pytest.raises(ValueError, match="does not divide"):
        check_axes(2, 2, world=6)
    cfg = get_config("synthetic_tiny")  # T = 32, two levels
    check_axes(1, 16, world=16, cfg=cfg)
    for t, time in ((36, 4), (32, 32), (30, 2)):
        short = cfg.replace(data=dataclasses.replace(cfg.data, num_clips=t))
        with pytest.raises(ValueError, match="does not split"):
            check_axes(1, time, world=time, cfg=short)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(model_axis=2)
    with pytest.raises(AssertionError, match="does not split"):
        row_block({"x": np.zeros((6, 2))}, 0, 4)
    for flag in ("--model-axis", "--time-axis"):
        with pytest.raises(SystemExit):
            port_train.main(["--config", "synthetic_tiny", flag, "2",
                             "--device", "cpu"])
