"""The run's vocabulary, datasets and host batching (own copies of
`build_vocab`, `make_dataset`, `BatchIterator` and `_pad_batch_rows` from
drn_tpu/data/pipeline.py): fixed-size batches, the ragged last one padded
and masked via `valid`. Padded rows keep query_mask[:, 0] = True (LSTM
lengths >= 1) and gt_grid = [0, 1]. Batches are built in process: worker
processes (`data.num_workers > 0`) are refused by the entry points."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from drn_tpu_torch.config import DataConfig, ModelConfig
from drn_tpu_torch.data.datasets import load_dataset, parse_examples
from drn_tpu_torch.data.vocab import Vocab, tokenize


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


class BatchIterator:
    """Deterministic epoch iterator over a dataset of example dicts."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder

    def __len__(self):
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_remainder else -(-n // b)

    def epoch(self, epoch_idx: int = 0, skip_batches: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(idx)
        b = self.batch_size
        stop = (n // b) * b if self.drop_remainder else n
        for off in range(skip_batches * b, stop, b):
            rows = [self.dataset[int(i)] for i in idx[off:off + b]]
            batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            yield _pad_batch_rows(batch, b)
