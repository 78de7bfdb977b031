"""The general generator: weights, feature tables and query splits made
from `--seed` and a traffic file's parameters.

Everything is drawn on the run's device where it is large (weights and
tables: one `torch.randn` each, from a generator on that device) and by
NumPy where it is small (the queries). The same seed gives the same
inputs; the sizes come from the traffic file alone, so every seed does
the same work on other values.

Traffic parameters read here (port_bench/traffic/<mix>.json):

  videos, queries      split size: the table's rows and the queries over them
  batch                rows a step (the last batch of a pass is padded)
  query_len            [lo, hi] words a query, uniform
  moment_frac          [lo, hi] of the video a moment spans, uniform
  duration_s           [lo, hi] seconds a video lasts, uniform

Training takes a new order of the queries every epoch, from the seed.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, List

import numpy as np
import torch

PAD_ID = 0      # word id of padding
FIRST_WORD = 2  # ids 0 and 1 are padding and the unknown word


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of the run's seed."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (2 ** 63)


def device_generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, tag))
    return g


def weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 parameters in the checkpoint schema, from one draw: LayerNorm
    scales and the per-level distance scales 1 + 0.1·z, biases 0.1·z (the
    LSTMs' second bias, a constant of the model, 0), the embedding 0.1·z,
    every other weight z / sqrt(fan_in)."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    z = torch.randn(sum(sizes), generator=device_generator(device, seed,
                                                           "weights"),
                    device=device)
    out = {}
    for name, v in zip(names, z.split(sizes)):
        v = v.view(shapes[name])
        if name.endswith("bias_hh_l0"):
            out[name] = torch.zeros_like(v)
        elif name == "scales" or ("norm" in name and name.endswith("weight")):
            out[name] = 1.0 + 0.1 * v
        elif "bias" in name or name == "embed.weight":
            out[name] = 0.1 * v
        else:
            out[name] = v / math.sqrt(math.prod(shapes[name][1:]))
    return out


def table(traffic: dict, dims: dict, seed: int, device) -> torch.Tensor:
    """The split's staged features (videos, num_clips, feature_dim) fp32,
    N(0, 1)."""
    return torch.randn((traffic["videos"], dims["num_clips"],
                        dims["feature_dim"]),
                       generator=device_generator(device, seed, "table"),
                       device=device)


def queries(traffic: dict, dims: dict, seed: int) -> Dict[str, np.ndarray]:
    """The split's queries, in annotation order (a video's queries
    together): video_row, word_ids, query_mask, gt_grid (grid units),
    duration (seconds), valid."""
    rng = np.random.default_rng(stream(seed, "queries"))
    v, n = traffic["videos"], traffic["queries"]
    per_video = np.full(v, n // v)
    per_video[:n % v] += 1
    rng.shuffle(per_video)
    video_row = np.repeat(np.arange(v, dtype=np.int32), per_video)
    length = dims["max_query_len"]
    lo, hi = traffic["query_len"]
    lengths = rng.integers(lo, hi + 1, n)
    mask = np.arange(length)[None, :] < lengths[:, None]
    word_ids = rng.integers(FIRST_WORD, dims["vocab_size"], (n, length),
                            dtype=np.int32)
    word_ids[~mask] = PAD_ID
    frac = rng.uniform(*traffic["moment_frac"], n)
    start = rng.uniform(0.0, 1.0, n) * (1.0 - frac)
    t = float(dims["num_clips"])
    gt = np.stack([start, start + frac], axis=1) * t
    duration = rng.uniform(*traffic["duration_s"], v)[video_row]
    return {"video_row": video_row, "word_ids": word_ids,
            "query_mask": mask, "gt_grid": gt.astype(np.float32),
            "duration": duration.astype(np.float32),
            "valid": np.ones(n, bool)}


def collate(split: Dict[str, np.ndarray], rows: np.ndarray, batch: int
            ) -> Dict[str, np.ndarray]:
    """The batch of `rows`, padded to `batch` rows as the program's loader
    pads a ragged batch: valid False, GT [0, 1], one word of mask."""
    out = {k: v[rows] for k, v in split.items()}
    pad = batch - len(rows)
    if pad:
        out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                               v.dtype)])
               for k, v in out.items()}
        out["gt_grid"][-pad:] = np.asarray([0.0, 1.0], np.float32)
        out["query_mask"][-pad:, 0] = True
    return out


def eval_batches(split: Dict[str, np.ndarray], batch: int
                 ) -> List[Dict[str, np.ndarray]]:
    n = len(split["valid"])
    return [collate(split, np.arange(i, min(i + batch, n)), batch)
            for i in range(0, n, batch)]


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng([stream(seed, "order"), epoch]).permutation(n)


def train_batches(split: Dict[str, np.ndarray], batch: int, seed: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches, epoch after epoch, each epoch in its own order from
    the seed; an epoch's ragged last batch is padded."""
    n = len(split["valid"])
    epoch = 0
    while True:
        order = epoch_order(n, seed, epoch)
        for i in range(0, n, batch):
            yield collate(split, order[i:i + batch], batch)
        epoch += 1


class Batches:
    """A fixed list of batches in the program's loader interface
    (`epoch()`, `close()`), handed to `evaluate(batches=...)`."""

    def __init__(self, batches: List[Dict[str, np.ndarray]]):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch_idx: int = 0, skip_batches: int = 0):
        return iter(self.batches[skip_batches:])

    def close(self) -> None:
        pass
