"""Dataset loaders (own copy of drn_tpu/data/datasets.py): Charades-STA,
ActivityNet-Captions, TACoS, synthetic. One example per (video, query,
segment) triple:

    features   (num_clips, F) float32 — resampled pre-extracted clips
    word_ids   (max_query_len,) int32
    query_mask (max_query_len,) bool
    gt_grid    (2,) float32 — GT span in base-grid units [0, num_clips]
    duration   () float32   — video duration in seconds
    valid      () bool

Annotation formats:
  * Charades-STA: text lines "VID START END##sentence" (times in seconds).
  * ActivityNet-Captions: JSON {vid: {"duration": s, "timestamps":
    [[s,e],...], "sentences": [...]}}.
  * TACoS: JSON {vid: {"num_frames": n, "fps": f, "timestamps" (frames),
    "sentences"}}.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from drn_tpu_torch.config import DataConfig, ModelConfig
from drn_tpu_torch.data.features import FeatureReader, effective_feature_fps
from drn_tpu_torch.data.vocab import Vocab, tokenize


@dataclass
class Example:
    video_id: str
    sentence: str
    start_sec: float
    end_sec: float
    duration: float  # seconds; <= 0: derived from the feature rows on read


class GroundingDataset:
    """Fixed-shape numpy examples from annotations and feature files."""

    def __init__(self, cfg: DataConfig, mcfg: ModelConfig, vocab: Vocab,
                 examples: List[Example], reader: Optional[FeatureReader]):
        self.cfg = cfg
        self.mcfg = mcfg
        self.vocab = vocab
        self.examples = examples
        self.reader = reader

    def __len__(self):
        return len(self.examples)

    def __repr__(self):
        # Address-free and stable across processes, naming what identifies
        # the dataset (a loader's saved state may pin it).
        c = self.cfg
        return (f"GroundingDataset(dataset={c.dataset!r}, "
                f"features={c.feature_dir!r}, ann={c.annotation_path!r}, "
                f"num_clips={c.num_clips}, n={len(self.examples)})")

    def read_features(self, video_id: str):
        """Resampled (num_clips, F) grid and raw row count, with the
        missing-file diagnostic that item reads and staging share."""
        try:
            return self.reader.read_resampled(video_id, self.cfg.num_clips)
        except (FileNotFoundError, KeyError) as e:
            raise FileNotFoundError(
                f"annotations reference video {video_id!r} but its "
                f"features are missing from {self.cfg.feature_dir!r} ({e}) "
                f"— check DataConfig.feature_dir / --feature-dir"
            ) from e

    def annotation_row(self, i: int, t_raw: int) -> Dict[str, np.ndarray]:
        """The feature-free part of example i (query ids and mask, GT span,
        duration, valid). Charades annotations carry no duration: it is
        `t_raw` over the configured extraction rate (warned once when the
        rate is unset)."""
        ex = self.examples[i]
        cfg = self.cfg
        duration = (ex.duration if ex.duration > 0
                    else float(t_raw) / effective_feature_fps(
                        cfg.feature_fps))
        ids, mask = self.vocab.encode(
            tokenize(ex.sentence, cfg.lowercase), cfg.max_query_len)
        scale = cfg.num_clips / max(duration, 1e-6)
        gs = np.clip(ex.start_sec * scale, 0.0, cfg.num_clips)
        ge = np.clip(ex.end_sec * scale, 0.0, cfg.num_clips)
        if ge <= gs:
            ge = min(gs + 1e-3, float(cfg.num_clips))
        return {
            "word_ids": ids,
            "query_mask": mask,
            "gt_grid": np.asarray([gs, ge], np.float32),
            "duration": np.float32(duration),
            "valid": np.bool_(True),
        }

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        feats, t_raw = self.read_features(self.examples[i].video_id)
        row = self.annotation_row(i, t_raw)
        row["features"] = feats
        return row


def parse_charades_sta(path: str) -> List[Example]:
    """Lines "VID START END##sentence"; others are skipped."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or "##" not in line:
                continue
            meta, sentence = line.split("##", 1)
            parts = meta.split()
            if len(parts) < 3:
                continue
            vid, start, end = parts[0], float(parts[1]), float(parts[2])
            out.append(Example(vid, sentence, start, end, duration=-1.0))
    return out


def parse_activitynet(path: str) -> List[Example]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out = []
    for vid, item in data.items():
        dur = float(item["duration"])
        for (s, e), sent in zip(item["timestamps"], item["sentences"]):
            out.append(Example(vid, sent, float(s), float(e), dur))
    return out


def parse_tacos(path: str) -> List[Example]:
    """Timestamps in frames, converted to seconds by each video's fps; the
    video id loses its ".avi"."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out = []
    for vid, item in data.items():
        fps = float(item["fps"])
        dur = float(item["num_frames"]) / fps
        for (s, e), sent in zip(item["timestamps"], item["sentences"]):
            out.append(Example(vid.replace(".avi", ""), sent,
                               float(s) / fps, float(e) / fps, dur))
    return out


_PARSERS = {
    "charades": parse_charades_sta,
    "activitynet": parse_activitynet,
    "tacos": parse_tacos,
}


def parse_examples(cfg: DataConfig, split: str = "train") -> List[Example]:
    """Parse one split's annotation file (`{split}` in the path is
    replaced by the split's name)."""
    parser = _PARSERS.get(cfg.dataset)
    if parser is None:
        raise KeyError(f"unknown dataset {cfg.dataset!r}")
    ann = cfg.annotation_path
    if "{split}" in ann:
        ann = ann.format(split=split)
    if not os.path.exists(ann):
        raise FileNotFoundError(
            f"annotation file {ann!r} not found — point DataConfig."
            f"annotation_path at the dataset release (use dataset='synthetic' "
            f"for the offline fixture)")
    return parser(ann)


def load_dataset(cfg: DataConfig, mcfg: ModelConfig, vocab: Vocab,
                 split: str = "train"):
    if cfg.dataset == "synthetic":
        from drn_tpu_torch.data.synthetic import SyntheticDataset

        # In GloVe mode the embedding table has the vocab's row count: cap
        # the fixture's ids to it.
        return SyntheticDataset(cfg, mcfg, split=split,
                                vocab_size=vocab.size if vocab else None)
    examples = parse_examples(cfg, split)
    return GroundingDataset(
        cfg, mcfg, vocab, examples,
        FeatureReader(cfg.feature_dir, cache_mb=cfg.feature_cache_mb))
