"""Whole `evaluate()` calls, streamed against staged on the device (port of
scripts/staged_eval_probe.py).

    python -m drn_tpu_torch.probes.staged_eval --videos 512 \\
        --queries-per-video 8
    python -m drn_tpu_torch.probes.staged_eval --device cpu \\
        --config synthetic_tiny --videos 4 --dim 16 --rows 8,12   # rehearsal

On host_pipeline's corpus (written by its `build_corpus`), with seeded
random weights at `--config`'s width, `--dim` features: the wall-clock of
what a user waits for, rows on stderr:

  - `streaming_epoch_cold` / `_warm`: `evaluate()` streaming every batch
    through the FeatureReader (one dataset, so its LRU does its job; the
    cold row reads a fresh dataset);
  - `staging_pass`: `evaluate.stage_on_device`, the staging
    `evaluate(device_features=True)` does (each unique video read once,
    one table, copied to the device);
  - `staged_epoch_<e>`, `--epochs` of them: the rest of that call,
    `evaluate` over that table (`table=`), the host feeding ids and row
    indices, as the JAX probe timed the loop over a table staged once.

The first step of each path runs before the rows on zeros (no file read),
so no row pays for a first launch. The streamed and staged metrics must be
equal: a difference raises. The summary (one JSON line on stdout) has the
warm streaming row, the best staged row and their ratio. Runs on `cuda`
unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="streamed vs staged evaluate()")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "drn_staged_corpus"))
    p.add_argument("--videos", type=int, default=512)
    p.add_argument("--dim", type=int, default=4096)
    p.add_argument("--rows", default="96,160")
    p.add_argument("--queries-per-video", type=int, default=8)
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--epochs", type=int, default=2,
                   help="staged evaluate() calls")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    import torch

    from drn_tpu_torch.bench import device_name
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.data.pipeline import make_dataset
    from drn_tpu_torch.evaluate import (build_model, eval_batches, evaluate,
                                        make_eval_step, resolve_device,
                                        stage_on_device)
    from drn_tpu_torch.probes.host_pipeline import (build_corpus,
                                                    corpus_config)

    dev = resolve_device(args.device)
    rows_lo, rows_hi = (int(x) for x in args.rows.split(","))
    t0 = time.perf_counter()
    stats = build_corpus(args.out, args.videos, args.dim, rows_lo, rows_hi,
                         args.queries_per_video)
    print(f"[probe +{time.perf_counter() - t0:5.1f}s] corpus: "
          f"{stats['examples']} examples / {args.videos} videos, "
          f"{stats['raw_gb']:.2f} GB", file=sys.stderr, flush=True)
    cfg = corpus_config(get_config(args.config), args.out, stats, args.dim)
    model = build_model(cfg, device=dev, seed=0)

    results = []

    def timed(tag, fn):
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t
        row = {"phase": tag, "seconds": dt,
               "examples_per_s": stats["examples"] / dt}
        results.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        return out

    # One step of each path on zeros: the kernels' libraries, cuDNN's LSTM
    # and the allocator are ready before the first timed row.
    b, l = cfg.eval.batch_size, cfg.data.max_query_len
    zeros = {"features": torch.zeros((b, cfg.data.num_clips, args.dim),
                                     device=dev),
             "word_ids": torch.zeros((b, l), dtype=torch.int32, device=dev),
             "query_mask": torch.ones((b, l), dtype=torch.bool, device=dev),
             "gt_grid": torch.tensor([[0.0, 1.0]], device=dev).repeat(b, 1),
             "duration": torch.ones((b,), device=dev),
             "valid": torch.ones((b,), dtype=torch.bool, device=dev)}
    step = make_eval_step(cfg, model)
    step(zeros)
    staged = {**zeros, "video_row": torch.zeros((b,), dtype=torch.int32,
                                                device=dev)}
    step({k: v for k, v in staged.items() if k != "features"},
         zeros["features"][:1])
    del zeros, staged
    print("[probe] both paths warm", file=sys.stderr, flush=True)

    ds = make_dataset(cfg.data, cfg.model, split="train")
    m_cold = timed("streaming_epoch_cold",
                   lambda: evaluate(cfg, model, ds, device=dev))
    m_warm = timed("streaming_epoch_warm",
                   lambda: evaluate(cfg, model, ds, device=dev))
    if m_cold != m_warm:
        raise RuntimeError(f"streamed epochs differ: {m_cold} vs {m_warm}")
    table, view = timed("staging_pass", lambda: stage_on_device(
        make_dataset(cfg.data, cfg.model, split="train"), dev))

    def staged_epoch():
        batches = eval_batches(cfg, view, dev)
        try:
            return evaluate(cfg, model, device=dev, batches=batches,
                            table=table)
        finally:
            batches.close()

    for e in range(args.epochs):
        m_staged = timed(f"staged_epoch_{e}", staged_epoch)
        if m_staged != m_warm:
            diffs = {k: (m_warm[k], m_staged.get(k)) for k in m_warm
                     if m_warm[k] != m_staged.get(k)}
            raise RuntimeError(f"staged metrics differ from streaming: "
                               f"{diffs}")

    warm = next(r for r in results if r["phase"] == "streaming_epoch_warm")
    staged_rows = [r for r in results if r["phase"].startswith("staged_")]
    best = max(staged_rows, key=lambda r: r["examples_per_s"])
    print(json.dumps({
        "probe": "staged_eval", "config": args.config,
        "device": device_name(dev),
        "corpus_examples": stats["examples"], "unique_videos": args.videos,
        "table_gb": args.videos * cfg.data.num_clips * args.dim * 4 / 1e9,
        "streaming_warm": warm, "staged_best": best,
        "staged_speedup": best["examples_per_s"] / warm["examples_per_s"],
        "metrics_match": True, "metrics": m_warm, "results": results,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
