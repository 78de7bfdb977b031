"""The run's vocabulary, datasets and host batching (own copies of
`build_vocab`, `make_dataset`, `BatchIterator`, `make_batch_iterator` and
`_pad_batch_rows` from drn_tpu/data/pipeline.py): fixed-size batches, the
ragged last one padded and masked via `valid`. Padded rows keep
query_mask[:, 0] = True (LSTM lengths >= 1) and gt_grid = [0, 1].

`data.num_workers > 0` builds the batches in worker processes
(`WorkerBatchIterator`, in place of the JAX package's Grain loader); the
batches are the in-process iterator's, one for one.

Data parallel (`rank`, `world`): every rank walks the same global batches
(the same order, the same `len()`, so no rank runs out of steps before
the others) and collates only its block of each (parallel/mesh.py::
row_block), `batch_size / world` rows; the blocks of all ranks make the
padded global batch. The port has no Grain, so there are no per-process
record shards of unequal length and nothing like the JAX package's
`lockstep_epoch` to pad them.
"""

from __future__ import annotations

import signal
from typing import Dict, Iterator, List, Optional

import numpy as np

from drn_tpu_torch.config import DataConfig, ModelConfig
from drn_tpu_torch.data.datasets import load_dataset, parse_examples
from drn_tpu_torch.data.vocab import Vocab, tokenize
from drn_tpu_torch.parallel.mesh import row_block


def build_vocab(cfg: DataConfig, mcfg: ModelConfig) -> Vocab:
    """The run's one vocabulary, shared by every split and the model:
    hashed without a GloVe file; with one, the GloVe table filtered to the
    words of every split's annotations, so train and eval ids agree. Its
    `embeddings` go to `build_model`, so the table and the ids match."""
    if not cfg.glove_path:
        return Vocab.hashed(mcfg.vocab_size)
    if cfg.dataset == "synthetic":
        return Vocab.from_glove(cfg.glove_path, mcfg.embed_dim)
    words = set()
    for split in ("train", "test", "val"):
        try:
            for ex in parse_examples(cfg, split):
                words.update(tokenize(ex.sentence, cfg.lowercase))
        except (FileNotFoundError, KeyError, ValueError):
            continue
    return Vocab.from_glove(cfg.glove_path, mcfg.embed_dim,
                            filter_words=words or None)


def make_dataset(cfg: DataConfig, mcfg: ModelConfig,
                 vocab: Optional[Vocab] = None, split: str = "train"):
    if vocab is None:
        vocab = build_vocab(cfg, mcfg)
    return load_dataset(cfg, mcfg, vocab, split)


def _pad_batch_rows(batch: Dict[str, np.ndarray], batch_size: int
                    ) -> Dict[str, np.ndarray]:
    """Pad a ragged final batch to the fixed batch size (masked via `valid`)."""
    n = batch["valid"].shape[0]
    pad = batch_size - n
    if pad <= 0:
        return batch
    out = {}
    for k, v in batch.items():
        block = np.zeros((pad,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, block])
    out["valid"][n:] = False
    out["gt_grid"][n:] = np.asarray([0.0, 1.0], np.float32)
    out["query_mask"][n:, 0] = True  # keep LSTM lengths >= 1
    return out


def epoch_order(n: int, shuffle: bool, seed: int, epoch_idx: int
                ) -> np.ndarray:
    """The example order of an epoch: a function of (seed, epoch) alone."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch_idx).shuffle(idx)
    return idx


def collate(dataset, indices, batch_size: int) -> Dict[str, np.ndarray]:
    """The batch of `dataset`'s examples `indices`, padded to
    `batch_size`. No indices (a rank's block past a ragged batch's end):
    padding rows alone, shaped after example 0."""
    rows = [dataset[int(i)] for i in indices] or [dataset[0]]
    batch = {k: np.stack([r[k] for r in rows])[:len(indices)]
             for k in rows[0]}
    return _pad_batch_rows(batch, batch_size)


class BatchIterator:
    """Deterministic epoch iterator over a dataset of example dicts:
    `batch_size` is the global batch, of which rank `rank` of `world`
    collates its block."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = False,
                 rank: int = 0, world: int = 1):
        assert batch_size % world == 0, (
            f"batch_size {batch_size} does not split over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.rank, self.world = rank, world
        self.local_batch_size = batch_size // world

    def __len__(self):
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_remainder else -(-n // b)

    def batch_indices(self, epoch_idx: int = 0, skip_batches: int = 0
                      ) -> Iterator[List[int]]:
        """The example indices of each batch of the epoch, from batch
        `skip_batches` on."""
        n, b = len(self.dataset), self.batch_size
        idx = epoch_order(n, self.shuffle, self.seed, epoch_idx)
        stop = (n // b) * b if self.drop_remainder else n
        for off in range(skip_batches * b, stop, b):
            yield idx[off:off + b].tolist()

    def rank_indices(self, epoch_idx: int = 0, skip_batches: int = 0
                     ) -> Iterator[List[int]]:
        """This rank's block of each of `batch_indices`' lists."""
        for indices in self.batch_indices(epoch_idx, skip_batches):
            yield row_block(indices, self.rank, self.world, self.batch_size)

    def epoch(self, epoch_idx: int = 0, skip_batches: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        for indices in self.rank_indices(epoch_idx, skip_batches):
            yield collate(self.dataset, indices, self.local_batch_size)

    def start(self) -> None:
        pass

    def close(self) -> None:
        pass


class _EpochSampler:
    """The batch sampler of a WorkerBatchIterator: the index lists of
    `BatchIterator.rank_indices` for the epoch and skip last set."""

    def __init__(self, order: BatchIterator):
        self.order = order
        self.epoch_idx, self.skip = 0, 0
        self.idle = False  # yields nothing: the pool starts, reads nothing

    def __iter__(self):
        if self.idle:
            return iter(())
        return self.order.rank_indices(self.epoch_idx, self.skip)


class _Batches:
    """The map-style dataset the workers index: a list of example indices
    → that batch, padded (numpy; the loader hands it over as tensors in
    shared memory)."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __getitem__(self, indices: List[int]) -> Dict[str, np.ndarray]:
        return collate(self.dataset, indices, self.batch_size)


# Seconds `WorkerBatchIterator.close` waits for a worker still alive after
# the loader's shutdown before it kills it.
WORKER_EXIT_S = 10.0


def _ignore_sigterm(worker_id: int) -> None:
    """A worker's init: SIGTERM ignored. A scheduler that signals every
    process of the job (Slurm, systemd's control group, `kill -TERM
    -<pgid>`) must reach the trainer's preemption guard alone; a worker
    killed by it would make the loader raise in the training loop before
    the save. The parent stops the workers itself (`close()`), and a
    worker whose parent died exits on its own. The worker was born with
    SIGTERM blocked (`WorkerBatchIterator.start`), so a signal sent while
    its interpreter was still starting is pending here: SIG_IGN discards
    it before the unblock."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGTERM})


class WorkerBatchIterator(BatchIterator):
    """BatchIterator's batches, built in `num_workers` worker processes
    (torch.utils.data.DataLoader over a batch sampler); a rank's workers
    read its rows alone.

    The sampler yields exactly `BatchIterator.rank_indices`: the same
    `default_rng(seed + epoch)` order, the same slices, the same padding.
    Because the order is a function of (seed, epoch) alone, a mid-epoch
    resume (`epoch(e, skip_batches=k)`) starts the sampler at batch k: no
    worker reads a consumed example, and no loader state needs saving
    beside the checkpoint. (The JAX package saves Grain's iterator state
    in `loader_state/` blobs, because Grain's order lives in its
    samplers.)

    Workers are started with "spawn" (by `start()`, or by the first
    epoch) and kept for the iterator's life (`close()` stops them); a
    caller that starts them early overlaps their start (an interpreter
    and torch each) with its own set-up. Nothing of the parent crosses
    but the pickled dataset (a FeatureReader drops its cache and HDF5
    handle on pickling; the native reader is loaded anew in each worker),
    so no CUDA context and no open handle is inherited. Workers ignore
    SIGTERM (`_ignore_sigterm`). Workers return numpy batches, which
    the loader moves through shared memory; with `pin_memory` the main
    process pins them before they are yielded, ready for the copy to the
    card. Batches are yielded as numpy arrays, as BatchIterator's are.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = False,
                 num_workers: int = 2, pin_memory: bool = False,
                 rank: int = 0, world: int = 1):
        super().__init__(dataset, batch_size, shuffle, seed, drop_remainder,
                         rank, world)
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}: use BatchIterator")
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self._sampler = _EpochSampler(self)
        self._loader = None

    def start(self) -> None:
        """Start the worker processes, without waiting for them and
        without reading anything."""
        if self._loader is not None:
            return
        from torch.utils.data import DataLoader

        self._loader = DataLoader(
            _Batches(self.dataset, self.local_batch_size), batch_size=None,
            sampler=self._sampler, num_workers=self.num_workers,
            pin_memory=self.pin_memory, persistent_workers=True,
            multiprocessing_context="spawn", worker_init_fn=_ignore_sigterm)
        self._sampler.idle = True
        # The workers are born with SIGTERM blocked (the mask crosses fork
        # and exec) and unblock it only once `_ignore_sigterm` has set
        # SIG_IGN: a group SIGTERM while an interpreter is still starting
        # would otherwise kill it. A SIGTERM to this process during the
        # spawn stays pending and reaches the trainer's guard on restore.
        old_mask = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
        try:
            iter(self._loader)  # spawns the pool; the idle sampler asks nothing
        finally:
            signal.pthread_sigmask(signal.SIG_SETMASK, old_mask)
        self._sampler.idle = False

    def epoch(self, epoch_idx: int = 0, skip_batches: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        self.start()
        self._sampler.epoch_idx, self._sampler.skip = epoch_idx, skip_batches
        for batch in self._loader:
            yield {k: v.numpy() for k, v in batch.items()}

    def close(self) -> None:
        """Stop the worker processes (a later epoch starts new ones), and
        wait until each has exited. The loader's last resort for a worker
        that outlives its shutdown, `terminate()`, sends SIGTERM, which
        the workers ignore: such a worker gets WORKER_EXIT_S more, then
        SIGKILL, so none outlives the iterator."""
        it = getattr(self._loader, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
            for w in it._workers:
                w.join(timeout=WORKER_EXIT_S)
                if w.is_alive():
                    w.kill()
                    w.join()
        self._loader = None


def make_batch_iterator(dataset, cfg: DataConfig, *, shuffle: bool,
                        seed: int, batch_size: Optional[int] = None,
                        pin_memory: bool = False, rank: int = 0,
                        world: int = 1) -> BatchIterator:
    """Worker processes when `cfg.num_workers > 0`, in process otherwise;
    the same batches either way. `batch_size` (the global batch) defaults
    to the config's; rank `rank` of `world` gets its block of each."""
    b = batch_size or cfg.batch_size
    if cfg.num_workers > 0:
        return WorkerBatchIterator(dataset, b, shuffle=shuffle, seed=seed,
                                   num_workers=cfg.num_workers,
                                   pin_memory=pin_memory, rank=rank,
                                   world=world)
    return BatchIterator(dataset, b, shuffle=shuffle, seed=seed, rank=rank,
                         world=world)
