"""Single-video inference CLI (port of drn_tpu/infer.py).

    python -m drn_tpu_torch.infer --config charades_c3d \\
        --torch-checkpoint stage2/best/1200.pth \\
        --features /data/c3d/VID123.npy --duration 31.2 \\
        --query "person opens the door"

Reads a parity-schema `.pth` (`--torch-checkpoint`) or a checkpoint
directory of the port (`--checkpoint-dir`, its `best/` first, as the JAX
CLI reads it), the video's features (a `.npy`, or an `.h5` with
`--video-id`), resamples them onto the grid, and prints each query's top
segments in seconds with their scores, through `evaluate.predict`. It runs
on `cuda` unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def load_features(path: str, video_id: str = "") -> np.ndarray:
    """Raw (T_raw, F) features of one video: a `.npy` file, or `video_id`
    of an HDF5 archive (any layout `FeatureReader` reads)."""
    if path.endswith((".h5", ".hdf5")):
        from drn_tpu_torch.data.features import FeatureReader

        return FeatureReader(path).read(video_id)
    return np.load(path)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="drn_tpu_torch single-video inference")
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a checkpoint directory of the port (best/ first)")
    p.add_argument("--torch-checkpoint", default=None,
                   help=".pth in the parity schema")
    p.add_argument("--features", required=True,
                   help="per-video .npy, or .h5 with --video-id")
    p.add_argument("--video-id", default="")
    p.add_argument("--query", required=True, action="append",
                   help="sentence; repeat for several queries")
    p.add_argument("--duration", type=float, default=0.0,
                   help="video duration in seconds (default: raw feature "
                        "rows / --feature-fps)")
    p.add_argument("--feature-fps", type=float, default=None,
                   help="feature rows per second (duration fallback)")
    p.add_argument("--glove-path", default=None)
    p.add_argument("--annotation-path", default=None,
                   help="needed in GloVe mode so the (dataset-filtered) "
                        "vocab matches the one the checkpoint was trained "
                        "with")
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--allow-config-mismatch", action="store_true",
                   help="downgrade the checkpoint-vs-active config check "
                        "to a warning")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    if not args.checkpoint_dir and not args.torch_checkpoint:
        p.error("one of --checkpoint-dir / --torch-checkpoint is required")
    if args.checkpoint_dir and args.torch_checkpoint:
        p.error("--checkpoint-dir and --torch-checkpoint are mutually "
                "exclusive; pass exactly one parameter source")

    from drn_tpu_torch.config import get_config, require_drn
    from drn_tpu_torch.data.features import (effective_feature_fps,
                                             resample_features)
    from drn_tpu_torch.data.pipeline import build_vocab
    from drn_tpu_torch.data.vocab import tokenize
    from drn_tpu_torch.evaluate import (build_model, load_params, predict,
                                        resolve_device, with_data_flags)

    device = resolve_device(args.device)  # no card: raise before any read
    cfg = with_data_flags(get_config(args.config), args)
    require_drn(cfg, "infer")
    raw = load_features(args.features, args.video_id)
    feats = resample_features(raw, cfg.data.num_clips)
    duration = (args.duration if args.duration > 0
                else float(raw.shape[0])
                / effective_feature_fps(cfg.data.feature_fps))

    vocab = build_vocab(cfg.data, cfg.model)
    ids, masks = zip(*(
        vocab.encode(tokenize(q, cfg.data.lowercase), cfg.data.max_query_len)
        for q in args.query))
    n = len(args.query)
    model = build_model(cfg, device=device,
                        pretrained_embeddings=vocab.embeddings)
    model.load_state_dict(load_params(args, cfg, context="infer"))
    batch = {
        "features": np.tile(feats[None], (n, 1, 1)),
        "word_ids": np.stack(ids),
        "query_mask": np.stack(masks),
        "duration": np.full((n,), duration, np.float32),
    }
    segs_sec, keep, scores = predict(cfg, model, batch, device=device)

    for qi, q in enumerate(args.query):
        print(f"query: {q!r}")
        shown = 0
        for k in range(segs_sec.shape[1]):
            if not keep[qi, k]:
                continue
            s, e = segs_sec[qi, k]
            print(f"  {shown + 1}. [{s:7.2f}s, {e:7.2f}s]  "
                  f"score={scores[qi, k]:.4f}")
            shown += 1
            if shown >= args.top:
                break


if __name__ == "__main__":
    main()
