"""Host feature-pipeline throughput (port of scripts/host_pipeline_probe.py).

    python -m drn_tpu_torch.probes.host_pipeline --videos 256 --out DIR
    python -m drn_tpu_torch.probes.host_pipeline --device cpu --videos 4 \\
        --dim 16 --rows 8,12 --workers "" --device-qps 100   # a rehearsal

The bench's numbers are the device step's alone (its batch is already on
the card); this probe measures what the host side delivers: the `.npy` read
+ resample + batch path. It writes an on-disk Charades-STA corpus (one
`.npy` of T_raw rows x dim fp32 a video, `--queries-per-video` annotations
each) and drains two epochs (cold: a fresh dataset, its LRU empty; then
warm) through the port's iterators:

  - BatchIterator, the native C++ reader (built before the rows),
  - BatchIterator under DRN_NATIVE_READER=0 (NumPy),
    each at feature_cache_mb 0 and at the config's LRU budget,
  - WorkerBatchIterator at each `--workers` count (the native reader, the
    LRU budget; in place of the JAX package's GrainBatchIterator). Its
    cold epoch includes the pool's start.

One JSON line a measurement on stdout, then a summary with the ratio to the
device's eval rate: `--device-qps`, or, when not given, the eval step's q/s
measured on `--device` by `bench.measure_qps` at the corpus's config
(charades_c3d at `--dim` and `--num-clips`). Runs on `cuda` unless
`--device cpu`; with no card it raises.

`build_corpus` writes the files and annotation the JAX package's builder
writes into a new directory; unlike it, it draws every video's features
even where the file exists (and writes them again), so the corpus is a
function of (seed, arguments) alone and a rerun writes the same
annotations.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np

FEATURE_FPS = 2.0  # feature rows per second of video


def build_corpus(root: str, videos: int, dim: int, rows_lo: int,
                 rows_hi: int, queries_per_video: int, seed: int = 0) -> Dict:
    """A Charades-STA-format corpus under `root` (`feats/VID<n>.npy`,
    `charades_sta_train.txt`) from `default_rng(seed)`; returns its paths
    and size."""
    feat_dir = os.path.join(root, "feats")
    os.makedirs(feat_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    total_bytes = 0
    for v in range(videos):
        vid = f"VID{v:05d}"
        rows = int(rng.integers(rows_lo, rows_hi + 1))
        np.save(os.path.join(feat_dir, f"{vid}.npy"),
                rng.normal(size=(rows, dim)).astype(np.float32))
        total_bytes += rows * dim * 4
        dur = rows / FEATURE_FPS
        for q in range(queries_per_video):
            s = float(rng.uniform(0, dur * 0.6))
            e = float(rng.uniform(s + 1.0, dur))
            lines.append(f"{vid} {s:.1f} {e:.1f}##person does thing {q}.")
    ann = os.path.join(root, "charades_sta_train.txt")
    with open(ann, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return {"annotation": ann, "feature_dir": feat_dir,
            "examples": len(lines), "raw_gb": total_bytes / 1e9,
            "bytes_per_example": total_bytes * queries_per_video
            / max(len(lines), 1)}


def corpus_config(base, root: str, stats: Dict, dim: int):
    """`base` reading the corpus under `root`: the Charades-STA reader, its
    annotation path, FEATURE_FPS, feature_dim `dim`."""
    return base.replace(
        data=dataclasses.replace(
            base.data, dataset="charades", feature_dir=stats["feature_dir"],
            annotation_path=os.path.join(root, "charades_sta_{split}.txt"),
            feature_fps=FEATURE_FPS),
        model=dataclasses.replace(base.model, feature_dim=dim))


def drain(it, epoch_idx: int):
    """(valid examples, seconds) of one epoch of `it`."""
    n = 0
    t0 = time.perf_counter()
    for batch in it.epoch(epoch_idx):
        n += int(batch["valid"].sum())
    return n, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="host feature-pipeline probe")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "drn_host_corpus"))
    p.add_argument("--videos", type=int, default=256)
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--rows", default="96,160",
                   help="raw feature row range lo,hi per video")
    p.add_argument("--queries-per-video", type=int, default=4)
    p.add_argument("--num-clips", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--workers", default="1,2,4,8",
                   help="WorkerBatchIterator worker counts ('' for none)")
    p.add_argument("--device-qps", type=float, default=None,
                   help="the device's eval rate to ratio against; measured "
                        "on --device when omitted")
    p.add_argument("--iters", type=int, default=32,
                   help="chained steps of that measurement")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch import native
    from drn_tpu_torch.bench import device_name, measure_qps
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import (BatchIterator,
                                             WorkerBatchIterator,
                                             make_dataset)
    from drn_tpu_torch.evaluate import resolve_device

    dev = resolve_device(args.device)
    rows_lo, rows_hi = (int(x) for x in args.rows.split(","))
    workers = [int(x) for x in args.workers.split(",") if x.strip()]
    t0 = time.perf_counter()
    stats = build_corpus(args.out, args.videos, args.dim, rows_lo, rows_hi,
                         args.queries_per_video)
    print(f"[probe +{time.perf_counter() - t0:5.1f}s] corpus: "
          f"{stats['examples']} examples over {args.videos} videos, "
          f"{stats['raw_gb']:.2f} GB raw features", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    if native.load() is None:
        raise RuntimeError("the native feature reader did not build")
    native_build_s = time.perf_counter() - t0

    cfg = corpus_config(get_config("charades_c3d"), args.out, stats,
                        args.dim)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, num_clips=args.num_clips, batch_size=args.batch_size))

    def new_ds(cache_mb):
        # A fresh dataset a measurement: the LRU lives on its reader.
        return make_dataset(dataclasses.replace(
            cfg.data, feature_cache_mb=cache_mb), cfg.model, split="train")

    # Unique feature bytes an epoch (what the disk serves cold), and the
    # bytes each example touches at cache 0 (it reads its whole video).
    corpus_bytes = stats["raw_gb"] * 1e9
    touched_per_ex = stats["bytes_per_example"]
    results = []

    def measure(tag, make_it, native_reader, cache_mb):
        before = os.environ.get("DRN_NATIVE_READER")
        os.environ["DRN_NATIVE_READER"] = "1" if native_reader else "0"
        it = make_it()
        try:
            for epoch in (0, 1):
                n, dt = drain(it, epoch)
                row = {
                    "pipeline": tag, "native_reader": native_reader,
                    "feature_cache_mb": cache_mb,
                    "epoch": "cold" if epoch == 0 else "warm",
                    "examples_per_s": n / dt,
                    "corpus_mb_per_s": corpus_bytes / dt / 1e6,
                    "touched_mb_per_s": n * touched_per_ex / dt / 1e6,
                    "examples": n, "seconds": dt}
                if not isinstance(it, WorkerBatchIterator):
                    reads = it.dataset.reader.native_reads  # workers':
                    if bool(reads) != native_reader:  # their own readers
                        raise RuntimeError(f"{tag}: {reads} native reads "
                                           f"with native_reader="
                                           f"{native_reader}")
                    row["native_reads"] = reads
                results.append(row)
                print(json.dumps(row), flush=True)
        finally:
            it.close()
            if before is None:
                del os.environ["DRN_NATIVE_READER"]
            else:
                os.environ["DRN_NATIVE_READER"] = before

    lru_mb = cfg.data.feature_cache_mb
    for native_reader in (True, False):
        for cache_mb in (0.0, lru_mb):
            measure("BatchIterator", lambda c=cache_mb: BatchIterator(
                new_ds(c), args.batch_size, shuffle=False), native_reader,
                cache_mb)
    for w in workers:
        measure(f"WorkerBatchIterator(workers={w})",
                lambda w=w: WorkerBatchIterator(
                    new_ds(lru_mb), args.batch_size, shuffle=False,
                    num_workers=w), True, lru_mb)

    device_qps, source = args.device_qps, "given"
    if device_qps is None:
        qcfg = get_config("charades_c3d")
        qcfg = qcfg.replace(
            data=dataclasses.replace(qcfg.data, num_clips=args.num_clips),
            model=dataclasses.replace(qcfg.model, feature_dim=args.dim))
        device_qps, _ = measure_qps(qcfg, args.iters, dev)
        source = "measured"
    warm = [r for r in results if r["epoch"] == "warm"]
    best = max(warm, key=lambda r: r["examples_per_s"])
    print(json.dumps({
        "probe": "host_pipeline",
        "corpus_examples": stats["examples"],
        "unique_bytes_per_example_mb": corpus_bytes / stats["examples"]
        / 1e6,
        "touched_bytes_per_example_mb": touched_per_ex / 1e6,
        "native_build_s": native_build_s,
        "best_warm": best,
        "device_qps": device_qps, "device_qps_source": source,
        "device": device_name(dev),
        "host_to_device_ratio": best["examples_per_s"] / device_qps,
        "implied_end_to_end_qps": min(best["examples_per_s"], device_qps),
        "results": results,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
