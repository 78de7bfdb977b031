"""Device-resident feature staging (own copy of drn_tpu/data/staging.py).

Each unique video is read once (a grounding dataset holds several queries
per video) into one (V, num_clips, F) fp32 table, which the caller puts on
the card. Batches then carry a `video_row` index instead of features, and
the step gathers `table[video_row]` on the device: the loop reads nothing
from disk. The table costs V · num_clips · F · 4 bytes of device memory
(Charades-STA test, about 1.3k videos at 64 × 4096: about 1.4 GB);
`stage_video_features` prints its size.

    table, view = stage_video_features(dataset)   # host, once
    table = torch.from_numpy(table).to("cuda")
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np


class StagedGroundingView:
    """A GroundingDataset whose rows carry `video_row` (int32 index into
    the staged table) instead of `features`; padded rows of a ragged last
    batch get row 0 with valid False, masked like any padding."""

    def __init__(self, base, row_of: Dict[str, int],
                 t_raw_of: Dict[str, int]):
        self.base = base
        self.row_of = row_of
        self.t_raw_of = t_raw_of

    def __len__(self):
        return len(self.base)

    def __repr__(self):
        return f"StagedGroundingView({self.base!r})"

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        vid = self.base.examples[i].video_id
        row = self.base.annotation_row(i, self.t_raw_of[vid])
        row["video_row"] = np.int32(self.row_of[vid])
        return row


def stage_video_features(dataset) -> Tuple[np.ndarray, StagedGroundingView]:
    """Read each unique video once → ((V, num_clips, F) float32 table, the
    feature-free view of `dataset` that indexes it). Rows in order of first
    appearance, so two stagings of one dataset agree."""
    vids = list(dict.fromkeys(ex.video_id for ex in dataset.examples))
    # Filled in place: stacking a list of grids would hold the table twice.
    table = np.zeros((max(len(vids), 1), dataset.cfg.num_clips,
                      dataset.mcfg.feature_dim), np.float32)
    row_of: Dict[str, int] = {}
    t_raw_of: Dict[str, int] = {}
    for r, vid in enumerate(vids):
        feats, t_raw = dataset.read_features(vid)
        table[r] = feats
        row_of[vid] = r
        t_raw_of[vid] = t_raw
    print(f"[staging] {len(vids)} unique videos for {len(dataset)} examples "
          f"→ feature table {table.shape} ({table.nbytes / 1e9:.2f} GB)",
          file=sys.stderr, flush=True)
    return table, StagedGroundingView(dataset, row_of, t_raw_of)
