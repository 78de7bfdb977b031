"""Dataset preflight validator (own copy of drn_tpu/data/validate.py):
catch real-data problems before a run on the card.

    python -m drn_tpu_torch.data.validate --config charades_c3d \
        --feature-dir /data/c3d --annotation-path /data/charades_sta_{split}.txt

Checks per split: annotations parse (counts, span sanity, query lengths
vs max_query_len), every referenced video has features (sampled), feature
dim matches the model config, features are finite, and — for formats that
carry no duration (Charades-STA) — whether the configured `feature_fps`
is consistent with the annotated span end-points. Exits non-zero on hard
errors (missing/unparseable/shape-mismatched data); warnings alone exit 0.

The report is also returned as a dict (one JSON line on stdout) so setup
scripts can gate on specific fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from drn_tpu_torch.config import ExperimentConfig, get_config
from drn_tpu_torch.data.datasets import parse_examples
from drn_tpu_torch.data.features import FeatureReader, effective_feature_fps
from drn_tpu_torch.data.vocab import UNK_ID, tokenize


def _pct(n: int, d: int) -> float:
    return round(100.0 * n / d, 2) if d else 0.0


def validate_split(cfg: ExperimentConfig, split: str, sample: int = 200,
                   vocab=None) -> Dict:
    """Validate one split; returns {errors: [..], warnings: [..], stats}."""
    d, errors, warnings = cfg.data, [], []
    try:
        examples = parse_examples(d, split)
    except (FileNotFoundError, KeyError, ValueError, json.JSONDecodeError,
            TypeError, AttributeError, IndexError) as e:
        # AttributeError/IndexError cover structurally-wrong-but-valid
        # JSON (e.g. a top-level list where a dict is expected) — the
        # validator must report those, not die with a traceback.
        return {"split": split, "errors": [f"annotations unreadable: {e}"],
                "warnings": [], "stats": {}}
    if not examples:
        return {"split": split,
                "errors": [f"annotation file for split {split!r} parsed to "
                           f"0 examples — wrong file or wrong dataset= "
                           f"setting?"],
                "warnings": [], "stats": {}}

    videos = sorted({ex.video_id for ex in examples})
    stats: Dict = {"examples": len(examples), "videos": len(videos)}

    # --- span sanity (annotation-only) ---
    neg_len = sum(1 for ex in examples if ex.end_sec <= ex.start_sec)
    neg_start = sum(1 for ex in examples if ex.start_sec < 0)
    over_dur = sum(1 for ex in examples
                   if ex.duration > 0 and ex.end_sec > ex.duration * 1.02)
    stats["spans_nonpositive_length"] = neg_len
    stats["spans_negative_start"] = neg_start
    stats["spans_past_annotated_duration"] = over_dur
    if neg_len:
        warnings.append(
            f"{neg_len} spans ({_pct(neg_len, len(examples))}%) have "
            f"end <= start (loader clamps them to 1e-3 grid units)")
    if neg_start:
        warnings.append(f"{neg_start} spans start before 0 s")
    if over_dur:
        warnings.append(
            f"{over_dur} spans end past the annotated video duration "
            f"(>2% over) — they will be clipped to the grid")

    # --- query length vs max_query_len ---
    token_lists = [tokenize(ex.sentence, d.lowercase) for ex in examples]
    lens = np.asarray([len(t) for t in token_lists])
    truncated = int((lens > d.max_query_len).sum())
    stats["query_tokens_p50"] = int(np.percentile(lens, 50))
    stats["query_tokens_p95"] = int(np.percentile(lens, 95))
    stats["query_tokens_max"] = int(lens.max())
    stats["queries_truncated"] = truncated
    if truncated:
        warnings.append(
            f"{truncated} queries ({_pct(truncated, len(examples))}%) "
            f"exceed max_query_len={d.max_query_len} and will be "
            f"truncated (longest: {int(lens.max())} tokens)")

    # --- vocab coverage (GloVe mode only; hashed mode has no OOV) ---
    if vocab is not None and vocab.word_to_id is not None:
        toks = [t for ts in token_lists for t in ts]
        oov = sum(1 for t in toks if vocab.lookup(t) == UNK_ID)
        stats["tokens_oov"] = oov
        stats["tokens_total"] = len(toks)
        if oov:
            warnings.append(
                f"{oov}/{len(toks)} tokens ({_pct(oov, len(toks))}%) are "
                f"out-of-vocabulary under the GloVe table (mapped to UNK)")

    # --- features (sampled videos) ---
    if not d.feature_dir:
        errors.append("DataConfig.feature_dir is empty — nothing to read "
                      "features from (pass --feature-dir)")
        return {"split": split, "errors": errors, "warnings": warnings,
                "stats": stats}
    reader = FeatureReader(d.feature_dir)
    if d.feature_dir.endswith((".h5", ".hdf5")):
        # Fail at archive granularity, not as N bogus per-video misses.
        if not os.path.exists(d.feature_dir):
            errors.append(
                f"feature archive {d.feature_dir!r} does not exist")
            return {"split": split, "errors": errors,
                    "warnings": warnings, "stats": stats}
        try:
            reader._h5_file()
        except ImportError:
            errors.append(
                "h5py is not installed — cannot read an .h5/.hdf5 "
                "feature archive (pip install h5py, or convert to a "
                ".npy directory)")
            return {"split": split, "errors": errors,
                    "warnings": warnings, "stats": stats}
        except OSError as e:
            errors.append(f"feature archive unreadable: {e}")
            return {"split": split, "errors": errors,
                    "warnings": warnings, "stats": stats}
    rng = np.random.default_rng(0)
    idx = (np.arange(len(videos)) if len(videos) <= sample
           else np.sort(rng.choice(len(videos), size=sample, replace=False)))
    checked = [videos[i] for i in idx]
    missing: List[str] = []
    bad_dim: List[str] = []
    nonfinite: List[str] = []
    t_raws: List[int] = []
    rows_by_vid: Dict[str, int] = {}
    feat_dim: Optional[int] = None
    for vid in checked:
        try:
            raw = reader.read(vid)
        except (FileNotFoundError, KeyError):
            missing.append(vid)
            continue
        except (ValueError, OSError) as e:
            errors.append(f"feature file for {vid!r} unreadable: {e}")
            continue
        if raw.ndim != 2:
            bad_dim.append(f"{vid}:ndim={raw.ndim}")
            continue
        t_raws.append(int(raw.shape[0]))
        rows_by_vid[vid] = int(raw.shape[0])
        if feat_dim is None:
            feat_dim = int(raw.shape[1])
        elif int(raw.shape[1]) != feat_dim:
            bad_dim.append(f"{vid}:F={raw.shape[1]}")
        if not np.isfinite(
                np.asarray(raw, np.float32)).all():
            nonfinite.append(vid)
    stats["videos_checked"] = len(checked)
    stats["videos_missing_features"] = len(missing)
    stats["feature_dim"] = feat_dim
    if t_raws:
        stats["feature_rows_p50"] = int(np.percentile(t_raws, 50))
        stats["feature_rows_min"] = int(min(t_raws))
        stats["feature_rows_max"] = int(max(t_raws))
    if missing:
        errors.append(
            f"{len(missing)}/{len(checked)} sampled videos have no "
            f"features in {d.feature_dir!r} (e.g. {missing[:3]}) — "
            f"training would crash on the first such batch")
    if bad_dim:
        errors.append(f"inconsistent feature shapes: {bad_dim[:5]}")
    if feat_dim is not None and feat_dim != cfg.model.feature_dim:
        errors.append(
            f"feature dim {feat_dim} != ModelConfig.feature_dim "
            f"{cfg.model.feature_dim} — wrong feature archive for this "
            f"config (c3d=4096 / i3d=1024)")
    if nonfinite:
        errors.append(f"{len(nonfinite)} sampled videos contain "
                      f"NaN/Inf features (e.g. {nonfinite[:3]})")

    # --- feature_fps consistency (duration-less formats only) ---
    durationless = [ex for ex in examples if ex.duration <= 0]
    if durationless and t_raws:
        # (row counts were recorded during the feature pass above — no
        # second read of the sampled files)
        fps = effective_feature_fps(d.feature_fps, warn=False)
        by_vid = {vid: n / fps for vid, n in rows_by_vid.items()}
        overs = [ex for ex in durationless if ex.video_id in by_vid
                 and ex.end_sec > by_vid[ex.video_id] * 1.05]
        stats["spans_past_derived_duration"] = len(overs)
        covered = sum(1 for ex in durationless if ex.video_id in by_vid)
        if covered and len(overs) > 0.2 * covered:
            warnings.append(
                f"{len(overs)}/{covered} spans end past the duration "
                f"derived from feature rows / feature_fps"
                f"{'' if d.feature_fps > 0 else ' (UNSET, assumed 1.0)'} "
                f"— the extraction rate is probably wrong; pass "
                f"--feature-fps with the real rate")
        if d.feature_fps <= 0:
            warnings.append(
                "feature_fps is unset for a duration-less annotation "
                "format; seconds outputs will assume 1 row/s")

    return {"split": split, "errors": errors, "warnings": warnings,
            "stats": stats}


def validate(cfg: ExperimentConfig, splits=("train", "test"),
             sample: int = 200) -> Dict:
    # A {split}-less annotation path (the ActivityNet/TACoS JSON releases
    # ship one concrete file per split) resolves every requested split to
    # the SAME file — validating it N times doubles the slow feature pass
    # and emits N identical reports. Collapse to one.
    collapsed = False
    if (len(splits) > 1 and cfg.data.dataset != "synthetic"
            and "{split}" not in cfg.data.annotation_path):
        splits, collapsed = splits[:1], True
    vocab = None
    if cfg.data.glove_path:
        try:
            from drn_tpu_torch.data.pipeline import build_vocab

            vocab = build_vocab(cfg.data, cfg.model)
        except (FileNotFoundError, ValueError) as e:
            return {"ok": False, "splits": [],
                    "errors": [f"GloVe table unreadable: {e}"]}
    reports = [validate_split(cfg, s, sample=sample, vocab=vocab)
               for s in splits]
    if collapsed:
        reports[0]["warnings"].append(
            "annotation_path has no {split} placeholder — every split "
            "resolves to the same file; validated it once")
    ok = not any(r["errors"] for r in reports)
    out = {"ok": ok, "splits": reports}
    if vocab is not None:
        out["glove_vocab_size"] = vocab.size
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="drn_tpu_torch dataset preflight validator")
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--feature-dir", default=None)
    p.add_argument("--annotation-path", default=None)
    p.add_argument("--glove-path", default=None)
    p.add_argument("--feature-fps", type=float, default=None)
    p.add_argument("--splits", default="train,test",
                   help="comma-separated split names to validate")
    p.add_argument("--sample", type=int, default=200,
                   help="videos to feature-check per split (all if fewer)")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    da = {}
    for field in ("feature_dir", "annotation_path", "glove_path",
                  "feature_fps"):
        v = getattr(args, field)
        if v is not None:
            da[field] = v
    if da:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **da))

    report = validate(cfg, splits=tuple(
        s for s in args.splits.split(",") if s), sample=args.sample)
    for r in report.get("splits", []):
        head = f"[{r['split']}]"
        for k, v in r.get("stats", {}).items():
            print(f"{head} {k} = {v}", file=sys.stderr)
        for w in r["warnings"]:
            print(f"{head} WARNING: {w}", file=sys.stderr)
        for e in r["errors"]:
            print(f"{head} ERROR: {e}", file=sys.stderr)
    for e in report.get("errors", []):
        print(f"ERROR: {e}", file=sys.stderr)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
