"""Feature-file IO and temporal resampling onto the fixed clip grid (own
copy of drn_tpu/data/features.py).

Reads a directory of `{video_id}.npy` arrays (T_raw, F) or one HDF5 file
keyed by video id, and interpolates each video linearly onto `num_clips`
uniformly spaced timestamps, so every batch has one fixed shape.
"""

from __future__ import annotations

import os
import threading
import warnings
from collections import OrderedDict
from typing import Optional

import numpy as np

from drn_tpu_torch import native

_warned_default_fps = False


def effective_feature_fps(feature_fps: float, warn: bool = True) -> float:
    """Feature rows per second to use for durations derived from row counts.

    `DataConfig.feature_fps == 0.0` means "not configured": assume 1 row/s
    and warn once, since the assumed rate scales every output in seconds
    (tIoU and recall do not see it). An explicit rate, even 1.0, silences
    it. `warn=False` is for callers that report the unset rate themselves
    (the validator)."""
    global _warned_default_fps
    if feature_fps > 0.0:
        return feature_fps
    if warn and not _warned_default_fps:
        _warned_default_fps = True
        warnings.warn(
            "DataConfig.feature_fps is unset; assuming 1.0 feature row per "
            "second to derive video durations. Segment outputs in SECONDS "
            "are wrong by exactly the ratio to the real extraction rate — "
            "set feature_fps (e.g. --feature-fps) to the rate your "
            "features were extracted at.",
            stacklevel=2)
    return 1.0


def resample_features(feats: np.ndarray, num_clips: int) -> np.ndarray:
    """(T_raw, F) → (num_clips, F) float32 by linear interpolation in time."""
    t_raw = feats.shape[0]
    if t_raw == num_clips:
        return feats.astype(np.float32)
    if t_raw == 1:
        return np.repeat(feats, num_clips, axis=0).astype(np.float32)
    src = np.linspace(0.0, t_raw - 1.0, num_clips)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, t_raw - 1)
    w = (src - lo)[:, None].astype(np.float32)
    out = feats[lo] * (1.0 - w) + feats[hi] * w
    return out.astype(np.float32)


class ResampledLru:
    """Byte-bounded, thread-safe LRU of resampled grids: key → (read-only
    (num_clips, F) float32 array, raw row count).

    Every annotation references a whole video and datasets hold several
    queries per video, so consecutive examples read the same file again.
    Hits share one read-only array (batching copies it through np.stack).
    `budget_mb <= 0` disables it: get misses, put drops."""

    def __init__(self, budget_mb: float):
        self.budget_mb = float(budget_mb)
        self._entries = OrderedDict()
        self._bytes = 0
        # The lock covers the bookkeeping only; reads run outside it.
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if self.budget_mb <= 0.0:
            return None
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key, feats: np.ndarray, t_raw: int):
        if self.budget_mb <= 0.0 or feats.nbytes > self.budget_mb * 1e6:
            return
        feats.flags.writeable = False
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = (feats, t_raw)
            self._bytes += feats.nbytes
            while self._bytes > self.budget_mb * 1e6:
                _, (old, _t) = self._entries.popitem(last=False)
                self._bytes -= old.nbytes


class FeatureReader:
    """Per-video features from a .npy directory or an .h5/.hdf5 file.

    `cache_mb` > 0 keeps a ResampledLru keyed by (video_id, num_clips).
    `native_reads` counts the reads the native reader served (.npy files
    it takes); the others went through NumPy."""

    def __init__(self, feature_dir: str, cache_mb: float = 0.0):
        self.feature_dir = feature_dir
        self.cache_mb = float(cache_mb)
        self._h5 = None
        self._is_h5 = feature_dir.endswith((".h5", ".hdf5"))
        self._cache = ResampledLru(self.cache_mb)
        self.native_reads = 0

    @property
    def cache_hits(self):
        return self._cache.hits

    @property
    def cache_misses(self):
        return self._cache.misses

    def __getstate__(self):
        # Locks and h5 handles do not pickle, and a copy in another process
        # would not share the cache anyway: it starts with an empty one.
        d = self.__dict__.copy()
        for k in ("_cache", "_h5"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._h5 = None
        self._cache = ResampledLru(self.cache_mb)

    def _h5_file(self):
        if self._h5 is None:
            import h5py  # optional; only HDF5 archives need it

            self._h5 = h5py.File(self.feature_dir, "r")
        return self._h5

    def num_frames(self, video_id: str) -> Optional[int]:
        try:
            return self.read(video_id).shape[0]
        except (FileNotFoundError, KeyError):
            return None

    def read(self, video_id: str) -> np.ndarray:
        if self._is_h5:
            f = self._h5_file()
            if video_id not in f:
                raise KeyError(video_id)
            node = f[video_id]
            if not hasattr(node, "shape"):
                # A group, not a dataset: the public ActivityNet C3D
                # release nests features one level down
                # (f["v_..."]["c3d_features"]). Take the one child whose
                # name mentions "feature", else a sole child; anything else
                # is ambiguous.
                keys = list(node.keys())
                named = [k for k in keys if "feature" in k.lower()]
                if len(named) == 1:
                    node = node[named[0]]
                elif len(keys) == 1:
                    node = node[keys[0]]
                # ValueError, not KeyError: callers read KeyError as "video
                # missing" and would swallow the diagnostic.
                if not hasattr(node, "shape"):
                    raise ValueError(
                        f"HDF5 group {video_id!r} in {self.feature_dir!r} "
                        f"does not resolve to a feature array (children: "
                        f"{keys[:4]}) — re-export with one dataset per "
                        f"video, or nest exactly one dataset (or one "
                        f"named '*feature*') per group")
            return np.asarray(node)
        path = os.path.join(self.feature_dir, f"{video_id}.npy")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return np.load(path)

    def read_resampled(self, video_id: str, num_clips: int
                       ) -> tuple[np.ndarray, int]:
        """→ ((num_clips, F) float32, raw row count). A .npy file is read
        and resampled in one native pass (mmap'd, the raw array never
        materialised); HDF5 and what the native reader refuses go through
        NumPy. Cached per video when cache_mb > 0: the array is then
        read-only and shared."""
        key = (video_id, num_clips)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        feats, t_raw = self._read_resampled_uncached(video_id, num_clips)
        self._cache.put(key, feats, t_raw)
        return feats, t_raw

    def _read_resampled_uncached(self, video_id: str, num_clips: int
                                 ) -> tuple[np.ndarray, int]:
        if not self._is_h5:
            path = os.path.join(self.feature_dir, f"{video_id}.npy")
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            res = native.read_resample(path, num_clips)
            if res is not None:
                self.native_reads += 1
                return res
        raw = self.read(video_id)
        return resample_features(raw, num_clips), int(raw.shape[0])
