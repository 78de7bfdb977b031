"""The port's preemption guard (drn_tpu_torch/utils/preemption.py), twin of
tests/test_preemption.py: SIGTERM → the step in flight finishes → the
trainer force-saves it → exit 75 → a rerun resumes past it.

The end-to-end case runs the port's train CLI on the CPU in a child
process (synthetic_tiny steps in milliseconds there), each child under a
timer that kills it: 120 s, far above the ~5 s it takes.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from drn_tpu_torch.utils import preemption as P
from drn_tpu_torch.utils.preemption import (PREEMPTED_EXIT_CODE,
                                            PreemptionGuard, exit_code_for)

REPO = str(Path(__file__).resolve().parents[1])
CHILD_TIMEOUT_S = 120


def test_guard_flags_after_sigterm_and_uninstalls():
    prev = signal.getsignal(signal.SIGTERM)
    seen = []

    def base_handler(s, f):
        seen.append(s)

    signal.signal(signal.SIGTERM, base_handler)
    try:
        with PreemptionGuard() as g:
            assert g.installed and g.preempted_at(1) is False
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 5
            while not g.preempted_at(2) and time.time() < deadline:
                time.sleep(0.01)
            assert g.preempted_at(2) is True and g.triggered
            assert seen == [signal.SIGTERM]  # chained, not eaten
        assert signal.getsignal(signal.SIGTERM) is base_handler
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_exit_code_for():
    g = PreemptionGuard()
    assert exit_code_for(None) == 0
    assert exit_code_for(g) == 0
    g.triggered = True
    assert exit_code_for(g) == PREEMPTED_EXIT_CODE == 75


def test_guard_degrades_off_main_thread():
    out = {}

    def worker():
        g = PreemptionGuard().install()
        out["installed"] = g.installed
        out["hit"] = g.preempted_at(1)
        g.uninstall()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out == {"installed": False, "hit": False}


def test_a_process_group_of_several_raises(monkeypatch):
    """More than one process must agree on the step to stop at: the
    guard installs there, and its poll is the MAX of the ranks' flags
    (here a stand-in for the group, in which a peer got the signal), so
    this rank stops at the same step with no signal of its own. What a
    group of several still refuses: staging the features
    (device_features), before any read. (tests/test_torch_parallel.py
    signals one of two real ranks.)"""
    polled = []
    monkeypatch.setattr(P, "any_rank",
                        lambda flag: polled.append(flag) or True)
    prev = signal.getsignal(signal.SIGTERM)
    with P.PreemptionGuard() as g:
        assert g.installed and not g.triggered
        assert g.preempted_at(3) and g.triggered
    assert polled == [False]  # no local signal: the peer's flag stopped it
    assert signal.getsignal(signal.SIGTERM) is prev

    from drn_tpu_torch import train as port_train
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.parallel.mesh import Mesh

    two = Mesh(rank=0, world=2, local_rank=0, device=None, group=None,
               flags=None)
    with pytest.raises(NotImplementedError, match="device_features"):
        port_train.train(get_config("charades_c3d"), device="cpu", mesh=two,
                         device_features=True)


def _spawn_trainer(ckpt_dir, max_steps, *extra, **popen_kw):
    """The train CLI on one torch thread, as the loader child runs. With
    its default of one OpenMP thread a core, the child's threads spin at
    every parallel region's barrier while the test run's other processes
    hold the cores: on 8 cores under 6 xdist workers a synthetic_tiny step
    took 8.2 s instead of 0.07 s, so a 10-step child ran past
    CHILD_TIMEOUT_S and was killed (rc -9)."""
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "drn_tpu_torch.train", "--config",
         "synthetic_tiny", "--device", "cpu", "--epochs", "50",
         "--max-steps", str(max_steps), "--checkpoint-dir", str(ckpt_dir),
         *extra],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        **popen_kw)


def _run(proc, on_line=None):
    """Stream the child's stderr lines to `on_line`; its exit code, the
    lines, and the seconds from the call to each stage ("step 1": the
    '"step": 1,' line; "eof": its stderr closed by every process holding
    it; "exit"). The child is killed after CHILD_TIMEOUT_S."""
    t0 = time.monotonic()
    times = {}
    killer = threading.Timer(CHILD_TIMEOUT_S, proc.kill)
    killer.start()
    lines = []
    try:
        for line in proc.stderr:
            lines.append(line)
            if "step 1" not in times and '"step": 1,' in line:
                times["step 1"] = round(time.monotonic() - t0, 2)
            if on_line:
                on_line(line)
        times["eof"] = round(time.monotonic() - t0, 2)
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
        times["exit"] = round(time.monotonic() - t0, 2)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
    return rc, lines, times


def _evidence(rc, lines, times):
    """What a failed assertion on a child run prints: its exit code, the
    seconds to each stage, and its last 30 stderr lines."""
    return (f"rc {rc}, seconds {times}, timeout {CHILD_TIMEOUT_S}; "
            "last stderr lines:\n" + "".join(lines[-30:]))


def _group_members(pgid):
    """(pid, ppid, state, cmdline) of every process of group `pgid`, read
    from /proc/<pid>/stat; state Z is a zombie that its parent has not yet
    reaped, not a live process."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        state, ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid:
            out.append((int(d), int(ppid), state, cmd.strip()))
    return out


def test_sigterm_saves_checkpoint_and_exits_75_then_resumes(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    proc = _spawn_trainer(ckpt_dir, 100_000)
    sent = []

    def on_line(line):
        if not sent and '"step": 1,' in line:
            sent.append(True)
            proc.send_signal(signal.SIGTERM)

    rc, lines, times = _run(proc, on_line)
    why = _evidence(rc, lines, times)
    assert rc == PREEMPTED_EXIT_CODE, why
    preempted = [json.loads(l) for l in lines if '"preempted"' in l]
    assert len(preempted) == 1, why
    saved_step = preempted[0]["step"]
    assert saved_step >= 1
    stage_dir = ckpt_dir / "synthetic_tiny" / "stage1"
    steps = sorted(int(p.stem) for p in stage_dir.glob("*.pth"))
    assert saved_step in steps, (saved_step, steps, why)
    assert torch.load(stage_dir / f"{saved_step}.pth",
                      weights_only=True)["step"] == saved_step

    # The rerun continues past it to the next logged step (every 10th):
    # it logs that step and not step 1, which a fresh start would log,
    # and its final save lands there.
    target = (saved_step // 10 + 1) * 10
    rc2, lines2, times2 = _run(_spawn_trainer(ckpt_dir, target))
    why2 = _evidence(rc2, lines2, times2)
    assert rc2 == 0, why2
    logged = [json.loads(l)["step"] for l in lines2
              if l.startswith("{") and '"loss"' in l]
    assert logged == [target], (saved_step, logged, why2)
    steps_after = sorted(int(p.stem) for p in stage_dir.glob("*.pth"))
    assert target in steps_after, (saved_step, steps_after, why2)


def test_sigterm_to_the_process_group_spares_the_workers(tmp_path):
    """A scheduler that signals every process of the job (Slurm, systemd's
    control group, `kill -TERM -<pgid>`) reaches the loader's worker
    processes too: they ignore it, so the trainer still saves the step it
    logged as preempted and exits 75, and no process of the group is left
    afterwards."""
    ckpt_dir = tmp_path / "ckpt"
    proc = _spawn_trainer(ckpt_dir, 100_000, "--num-workers", "2",
                          start_new_session=True)
    sent = []

    def on_line(line):
        if not sent and '"step": 1,' in line:
            sent.append(True)
            os.killpg(proc.pid, signal.SIGTERM)

    rc, lines, times = _run(proc, on_line)
    why = _evidence(rc, lines, times)
    assert sent and rc == PREEMPTED_EXIT_CODE, why
    preempted = [json.loads(l) for l in lines if '"preempted"' in l]
    assert len(preempted) == 1, why
    saved = ckpt_dir / "synthetic_tiny" / "stage1" / \
        f"{preempted[0]['step']}.pth"
    assert torch.load(saved, weights_only=True)["step"] == \
        preempted[0]["step"]
    deadline = time.time() + 30
    while True:
        try:
            os.killpg(proc.pid, 0)
        except ProcessLookupError:
            break
        assert time.time() < deadline, (
            "processes of the group outlived it (pid, ppid, state, "
            f"cmdline): {_group_members(proc.pid)}; {why}")
        time.sleep(0.1)


_LOADER_CHILD = r"""
import json, os, signal, sys
from drn_tpu_torch.config import get_config
from drn_tpu_torch.data.pipeline import WorkerBatchIterator, make_dataset

if __name__ == "__main__":
    got = []
    signal.signal(signal.SIGTERM, lambda *_: got.append(1))
    cfg = get_config("synthetic_tiny")
    ds = make_dataset(cfg.data, cfg.model)
    it = WorkerBatchIterator(ds, 8, shuffle=False, num_workers=2)
    it.start()
    os.killpg(0, signal.SIGTERM)
    held = []
    for w in it._loader._iterator._workers:
        status = dict(l.split(":\t", 1) for l in
                      open(f"/proc/{w.pid}/status").read().splitlines()
                      if l.startswith(("SigIgn", "SigBlk")))
        bit = 1 << (signal.SIGTERM - 1)
        held.append(bool((int(status["SigIgn"], 16)
                          | int(status["SigBlk"], 16)) & bit))
    n = sum(1 for _ in it.epoch(0))
    it.close()
    print(json.dumps({"batches": n, "expected": -(-len(ds) // 8),
                      "held": held, "parent_signalled": len(got)}))
"""


def test_sigterm_to_a_loader_group_at_start_loses_no_batch(tmp_path):
    """A group SIGTERM sent the moment the pool is spawned, while the
    workers' interpreters are still starting: the workers are born with
    SIGTERM blocked, so none dies, the epoch yields every batch, and the
    signal still reaches the parent."""
    script = tmp_path / "loader_child.py"
    script.write_text(_LOADER_CHILD)
    proc = subprocess.Popen(
        [sys.executable, str(script)], cwd=REPO, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["batches"] == res["expected"], res
    assert res["held"] == [True, True], res
    assert res["parent_signalled"] == 1, res
