"""Worker processes for the port's batches (data/pipeline.py::
WorkerBatchIterator), twins of tests/test_grain_pipeline.py held against
the port's own in-process BatchIterator: the same batches one for one
(Grain's are only the same multiset), the padding, the per-epoch shuffle,
real worker processes, the dispatch, and a mid-epoch resume that reads
none of the consumed examples, counted in the workers themselves.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.data import pipeline
from drn_tpu_torch.data.pipeline import (BatchIterator, WorkerBatchIterator,
                                         make_batch_iterator, make_dataset)

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ds():
    cfg = get_config("synthetic_tiny")
    d = make_dataset(cfg.data, cfg.model, split="train")
    d.num_examples = 21  # deliberately ragged against batch_size=8
    d._examples = d._examples[:21]
    return d


class _PidDS:
    """Each example tagged with the pid of the process that read it."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return {**self.inner[i], "pid": np.int64(os.getpid())}


class _CountingDS:
    """Appends every example index read to a file: the workers' reads are
    counted in the workers."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, str(log)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        with open(self.log, "a") as f:
            f.write(f"{int(i)}\n")
        return self.inner[int(i)]

    def reads(self):
        try:
            with open(self.log) as f:
                return [int(x) for x in f.read().split()]
        except FileNotFoundError:
            return []

    def reset(self):
        open(self.log, "w").close()


class _StuckDS:
    """Examples from index `stuck` on never come: the worker reading one
    sleeps (SIGTERM, ignored by the workers, does not wake it)."""

    def __init__(self, inner, stuck):
        self.inner, self.stuck = inner, stuck

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i >= self.stuck:
            time.sleep(600)
        return self.inner[i]


@pytest.fixture(scope="module")
def workers(ds, tmp_path_factory):
    """One pool of 2 workers for the module over the counted, pid-tagged
    examples (the order is set per epoch)."""
    counted = _CountingDS(_PidDS(ds), tmp_path_factory.mktemp("w") / "reads")
    it = WorkerBatchIterator(counted, 8, shuffle=False, num_workers=2)
    yield it
    it.close()


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        bg, bw = ({k: v for k, v in b.items() if k != "pid"}
                  for b in (bg, bw))
        assert bg.keys() == bw.keys()
        for k in bw:
            assert bg[k].dtype == bw[k].dtype, k
            np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def test_workers_match_the_simple_iterator_unshuffled(ds, workers):
    workers.shuffle = False
    simple = list(BatchIterator(ds, 8, shuffle=False).epoch(0))
    assert len(simple) == 3
    _assert_same_batches(list(workers.epoch(0)), simple)


def test_workers_final_batch_padding(ds, workers):
    workers.shuffle = False
    last = list(workers.epoch(0))[-1]
    assert last["features"].shape[0] == 8
    assert last["valid"][:5].all() and not last["valid"][5:].any()
    assert last["query_mask"][5:, 0].all()
    np.testing.assert_array_equal(last["gt_grid"][5:],
                                  np.tile([0.0, 1.0], (3, 1)))


def test_workers_shuffle_differently_per_epoch(ds, workers):
    workers.shuffle, workers.seed = True, 3
    e0 = list(workers.epoch(0))
    e1 = list(workers.epoch(1))
    assert not np.array_equal(np.concatenate([b["gt_grid"] for b in e0]),
                              np.concatenate([b["gt_grid"] for b in e1]))
    _assert_same_batches(list(workers.epoch(0)), e0)  # deterministic
    simple = BatchIterator(ds, 8, shuffle=True, seed=3)
    _assert_same_batches(e1, list(simple.epoch(1)))


def test_worker_processes(workers):
    workers.shuffle = False
    pids = {int(p) for b in workers.epoch(0) for p in b["pid"][b["valid"]]}
    assert os.getpid() not in pids
    assert len(pids) == 2  # three batches over two workers


def test_close_stops_a_worker_that_ignores_its_shutdown(ds, monkeypatch):
    """A worker still busy when the loader shuts its pool down outlives
    the loader's own last resort (`terminate()`, a SIGTERM the workers
    ignore): close() kills it after WORKER_EXIT_S, so no worker outlives
    the iterator."""
    monkeypatch.setattr(pipeline, "WORKER_EXIT_S", 1.0)
    it = WorkerBatchIterator(_StuckDS(ds, 8), 8, shuffle=False,
                             num_workers=2)
    batches = it.epoch(0)
    assert next(batches)["features"].shape[0] == 8  # the second sticks
    procs = list(it._loader._iterator._workers)
    t0 = time.monotonic()
    it.close()
    assert not any(w.is_alive() for w in procs)
    assert time.monotonic() - t0 < 60
    batches.close()


def test_make_batch_iterator_dispatch(ds):
    cfg = get_config("synthetic_tiny").data
    plain = make_batch_iterator(ds, cfg, shuffle=False, seed=0)
    assert type(plain) is BatchIterator
    w = make_batch_iterator(ds, dataclasses.replace(cfg, num_workers=2),
                            shuffle=False, seed=0, batch_size=4)
    assert isinstance(w, WorkerBatchIterator)
    assert (w.num_workers, w.batch_size, len(w)) == (2, 4, 6)


def test_resume_reads_nothing_twice(ds, workers):
    """epoch(e, skip_batches=k) yields the uninterrupted epoch's batches
    from k on, and its workers read only the examples of those batches."""
    ref = list(BatchIterator(ds, 8, shuffle=True, seed=5).epoch(0))
    consumed = set(next(BatchIterator(ds, 8, shuffle=True, seed=5)
                        .batch_indices(0)))
    workers.shuffle, workers.seed = True, 5
    workers.dataset.reset()
    rest = list(workers.epoch(0, skip_batches=1))
    _assert_same_batches(rest, ref[1:])
    assert len(consumed) == 8
    assert sorted(workers.dataset.reads()) == sorted(
        set(range(len(ds))) - consumed)


def test_train_mid_epoch_resume_skips_reads(tmp_path, monkeypatch):
    """Train 3 steps (a checkpoint each), then resume to 6: the resumed
    run's workers read none of the 24 examples the first run consumed."""
    cfg = get_config("synthetic_tiny")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, num_workers=2,
                                 synthetic_examples=64),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path),
                                  checkpoint_every_steps=1, num_epochs=1,
                                  eval_every_epochs=0))
    logs = iter([tmp_path / "reads0", tmp_path / "reads1"])
    counters = []
    real = pipeline.make_batch_iterator

    def counting(dataset, dcfg, **kw):
        counters.append(_CountingDS(dataset, next(logs)))
        return real(counters[-1], dcfg, **kw)

    monkeypatch.setattr(port_train, "make_batch_iterator", counting)
    info = {}
    port_train.train(cfg, device="cpu", max_steps=3, run_info=info)
    assert info == {"start_step": 0, "step": 3}
    order = BatchIterator(counters[0].inner, 8, shuffle=True,
                          seed=cfg.train.seed).batch_indices(0)
    consumed = {i for _ in range(3) for i in next(order)}
    assert consumed <= set(counters[0].reads())
    port_train.train(cfg, device="cpu", max_steps=6, run_info=info)
    assert info == {"start_step": 3, "step": 6}
    after = set(counters[1].reads())
    assert after and not after & consumed, sorted(after & consumed)


def test_evaluate_with_workers_equals_in_process():
    cfg = get_config("synthetic_tiny")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_examples=20),
        eval=dataclasses.replace(cfg.eval, batch_size=6))  # ragged
    model = port_eval.build_model(cfg, device="cpu", seed=2)
    want = port_eval.evaluate(cfg, model, device="cpu")
    got = port_eval.evaluate(cfg.replace(data=dataclasses.replace(
        cfg.data, num_workers=2)), model, device="cpu")
    assert got == want


def test_in_training_eval_keeps_one_worker_pool(tmp_path, monkeypatch):
    """Two epochs, each followed by the val-split eval: with workers the
    run starts two pools (train, eval) and no more, and each eval's
    metrics equal the in-process run's."""
    cfg = get_config("synthetic_tiny")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_examples=16),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path),
                                  num_epochs=2, eval_every_epochs=1))
    pools, results = [], []
    start = WorkerBatchIterator.start

    def counting_start(self):
        if self._loader is None:
            pools.append(self)
        start(self)

    def recording_evaluate(*a, **kw):
        results.append(port_eval.evaluate(*a, **kw))
        return results[-1]

    monkeypatch.setattr(WorkerBatchIterator, "start", counting_start)
    monkeypatch.setattr(port_train, "evaluate", recording_evaluate)
    port_train.train(cfg, device="cpu")
    want, results[:] = list(results), []
    port_train.train(cfg.replace(
        data=dataclasses.replace(cfg.data, num_workers=2),
        train=dataclasses.replace(cfg.train, resume=False)), device="cpu")
    assert len(pools) == 2 and len(want) == 2
    assert results == want
