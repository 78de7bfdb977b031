"""Tokenizer and vocabulary (own copy of drn_tpu/data/vocab.py), GloVe or
hashed:

  * GloVe mode: `Vocab.from_glove(path)` parses a `word v1 ... vD` text
    file; its `embeddings` become the model's (frozen) embedding table.
  * Hashed mode (no GloVe file): words map to `size` buckets by crc32, and
    the embedding table is random and trained. The ids equal the JAX
    package's bit for bit: checkpoints depend on them.

Ids 0/1 are PAD/UNK in both modes.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
UNK_ID = 1
_NUM_RESERVED = 2

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(sentence: str, lowercase: bool = True) -> List[str]:
    if lowercase:
        sentence = sentence.lower()
    return _TOKEN_RE.findall(sentence)


class Vocab:
    def __init__(self, size: int,
                 word_to_id: Optional[Dict[str, int]] = None,
                 embeddings: Optional[np.ndarray] = None):
        self.size = size
        self.word_to_id = word_to_id  # None: hashed mode
        self.embeddings = embeddings

    @classmethod
    def hashed(cls, size: int) -> "Vocab":
        return cls(size=size)

    @classmethod
    def from_glove(cls, path: str, embed_dim: int = 300,
                   max_words: int = 400_000,
                   filter_words: Optional[set] = None) -> "Vocab":
        """Parse a GloVe text file; with `filter_words` (the dataset's
        tokens) only those rows are kept. Lines without exactly
        `embed_dim` values (a header, a malformed row) are skipped. UNK's
        row is the mean of the kept rows, PAD's is zero."""
        words, vecs = [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) != embed_dim + 1:
                    continue
                if filter_words is not None and parts[0] not in filter_words:
                    continue
                words.append(parts[0])
                vecs.append(np.asarray(parts[1:], np.float32))
                if len(words) >= max_words:
                    break
        if not words:
            raise ValueError(f"no usable GloVe rows in {path!r}")
        table = np.zeros((len(words) + _NUM_RESERVED, embed_dim), np.float32)
        table[_NUM_RESERVED:] = np.stack(vecs)
        table[UNK_ID] = table[_NUM_RESERVED:].mean(axis=0)
        w2i = {w: i + _NUM_RESERVED for i, w in enumerate(words)}
        return cls(size=table.shape[0], word_to_id=w2i, embeddings=table)

    def lookup(self, word: str) -> int:
        if self.word_to_id is None:
            h = zlib.crc32(word.encode("utf-8"))
            return _NUM_RESERVED + h % (self.size - _NUM_RESERVED)
        return self.word_to_id.get(word, UNK_ID)

    def encode(self, tokens: Sequence[str], max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids (max_len,) int32, mask (max_len,) bool), truncated or
        padded; an empty query becomes one UNK so the LSTM has input."""
        ids = np.full((max_len,), PAD_ID, np.int32)
        mask = np.zeros((max_len,), bool)
        for i, tok in enumerate(tokens[:max_len]):
            ids[i] = self.lookup(tok)
            mask[i] = True
        if not mask.any():
            ids[0] = UNK_ID
            mask[0] = True
        return ids, mask
