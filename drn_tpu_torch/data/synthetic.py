"""Synthetic grounding fixture (own copy of drn_tpu/data/synthetic.py, the
same examples from the same seed): random "videos" hiding a query-dependent
signal inside the GT span, plus token queries."""

from __future__ import annotations

from typing import Dict

import numpy as np

from drn_tpu_torch.config import DataConfig, ModelConfig
from drn_tpu_torch.data.vocab import PAD_ID


class SyntheticDataset:
    def __init__(self, cfg: DataConfig, mcfg: ModelConfig, split: str = "train",
                 num_examples: int | None = None, vocab_size: int | None = None):
        self.cfg = cfg
        self.mcfg = mcfg
        seed = cfg.seed + (0 if split == "train" else 10_000)
        self.rng = np.random.default_rng(seed)
        if num_examples is None:
            num_examples = cfg.synthetic_examples
        self.num_examples = num_examples
        self.vocab_size = min(vocab_size or mcfg.vocab_size, mcfg.vocab_size)
        f, v = mcfg.feature_dim, self.vocab_size
        # A fixed random projection: token id → feature-space signal vector.
        proj_rng = np.random.default_rng(1234)
        self.token_signal = proj_rng.normal(size=(v, f)).astype(np.float32)
        self._examples = [self._make(i) for i in range(num_examples)]
        self._split = split

    def __repr__(self):
        return (f"SyntheticDataset(split={self._split!r}, "
                f"seed={self.cfg.seed}, n={self.num_examples}, "
                f"v={self.vocab_size})")

    def _make(self, i: int) -> Dict[str, np.ndarray]:
        cfg, mcfg = self.cfg, self.mcfg
        t, f, l = cfg.num_clips, mcfg.feature_dim, cfg.max_query_len
        n_words = int(self.rng.integers(2, l + 1))
        ids = np.full((l,), PAD_ID, np.int32)
        ids[:n_words] = self.rng.integers(2, self.vocab_size, n_words)
        mask = np.arange(l) < n_words

        length = self.rng.uniform(0.1, 0.6) * t
        start = self.rng.uniform(0, t - length)
        end = start + length

        feats = self.rng.normal(size=(t, f)).astype(np.float32)
        signal = self.token_signal[ids[:n_words]].mean(axis=0)
        inside = (np.arange(t) + 0.5 >= start) & (np.arange(t) + 0.5 < end)
        amp = cfg.synthetic_snr
        feats[inside] += amp * signal
        # Decoy spans: another query's signal outside the GT span.
        for _ in range(cfg.synthetic_distractors):
            d_n = int(self.rng.integers(2, l + 1))
            d_ids = self.rng.integers(2, self.vocab_size, d_n)
            d_signal = self.token_signal[d_ids].mean(axis=0)
            d_len = self.rng.uniform(0.1, 0.6) * t
            d_start = self.rng.uniform(0, t - d_len)
            d_inside = ((np.arange(t) + 0.5 >= d_start)
                        & (np.arange(t) + 0.5 < d_start + d_len) & ~inside)
            feats[d_inside] += amp * d_signal

        return {
            "features": feats,
            "word_ids": ids,
            "query_mask": mask,
            "gt_grid": np.asarray([start, end], np.float32),
            "duration": np.float32(60.0),
            "valid": np.bool_(True),
        }

    def __len__(self):
        return self.num_examples

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self._examples[i]
