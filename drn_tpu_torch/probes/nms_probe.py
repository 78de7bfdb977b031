"""The eval step's temporal NMS alone (port of scripts/nms_probe.py).

    python -m drn_tpu_torch.probes.nms_probe [--batch-size 48 --top-k 48]
    python -m drn_tpu_torch.probes.nms_probe --device cpu --iters 1

At the flagship's shapes (B=48 queries, K=48 candidates, IoU threshold
0.5), on the script's two inputs from seed 0: `random` (uniform starts and
lengths, normal scores) and `chain` (starts 4·i, length 10, descending
scores: every row one long suppression chain). Two rows an input, each
labelled by what it runs:

  - `fori_single`: the script's `nms_fori`, the sweep of one query (the
    K-step loop, its `arange(K) > i` mask built at each step), applied
    over the batch by `torch.vmap` as the script applies it by `jax.vmap`;
  - `package`: the port's `ops/nms.py::batched_temporal_nms`, as the eval
    step runs it: the sort and gather, then on the card one launch of
    `ops/cuda/nms_sweep.py`'s kernel (a block a query), on the CPU its
    plain version, the batched K-step sweep over a precomputed
    upper-triangular mask. It is the same sweep as `drn_tpu/ops/nms.py`'s
    `temporal_nms`, which the script's `nms_fix` row reaches: the JAX
    package removed its while-loop fixpoint (measured slower), so in the
    JAX script both rows time the one K-step sweep, and its "fixpoint"
    label no longer says what runs.

Each row (`bench.call_row`, in µs): the host clock's time a call of a
chain of `--iters` calls (the segments perturbed by the previous call's
consumed scalar), the device time a call from a profiler trace (summed and
union), and the kernels a call, which is where the eval step's NMS
launches are counted. `fori_single` rows also say whether its order, keep
mask and sorted segments equal the package's on that input
(`same_as_package`); the probe's caller gates on it. One JSON line a row on
stdout. Runs on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

THRESHOLD = 0.5


def nms_fori(segments: torch.Tensor, scores: torch.Tensor, thr: float):
    """One query's sweep (the script's `nms_fori`): (K, 2), (K,) →
    (order, keep, sorted segments)."""
    from drn_tpu_torch.ops.temporal import temporal_iou

    k = scores.shape[0]
    order = torch.sort(-scores, stable=True).indices
    segs = segments[order]
    iou = temporal_iou(segs[:, None, :], segs[None, :, :])
    idx = torch.arange(k, device=scores.device)
    keep = torch.ones(k, dtype=torch.bool, device=scores.device)
    for i in range(k):
        keep = keep & ~((idx > i) & (iou[i] > thr) & keep[i])
    return order, keep, segs


def fori_single(segments: torch.Tensor, scores: torch.Tensor, thr: float):
    """`nms_fori` over a batch, (B, K, 2), (B, K) → per-row results."""
    return torch.vmap(lambda s, c: nms_fori(s, c, thr))(segments, scores)


def make_inputs(b: int, k: int, seed: int = 0):
    """The script's inputs, same draws in the same order: {name:
    (segments (B, K, 2), scores (B, K))} as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 50, (b, k)).astype(np.float32)
    length = rng.uniform(1, 30, (b, k)).astype(np.float32)
    segs = np.stack([start, start + length], -1)
    scores = rng.normal(size=(b, k)).astype(np.float32)
    st = np.tile(np.arange(k, dtype=np.float32) * 4.0, (b, 1))
    chain = np.stack([st, st + 10.0], -1)
    chain_scores = np.tile(np.arange(k, 0, -1, dtype=np.float32), (b, 1))
    return {"random": (segs, scores), "chain": (chain, chain_scores)}


SWEEP_KINDS = ("random", "grid", "chain")


def sweep_inputs(b: int, k: int, kind: str, thr: float = THRESHOLD,
                 seed: int = 0) -> np.ndarray:
    """Segments (B, K, 2) fp32 already in rank order, the sweep's input
    (`ops/cuda/nms_sweep.py`):

      - `random`: starts uniform in [0, 100), lengths in [0.5, 30);
      - `grid`: starts and lengths on a coarse integer grid (0-15, 0-5):
        identical and zero-length segments, IoUs equal to the threshold;
      - `chain`: starts i, length 1.5·(1+thr)/(1−thr), so each candidate
        overlaps the next above `thr` and the one after below it: every
        rank's keep depends on the suppressed one before it (kept and
        suppressed alternate).
    """
    rng = np.random.default_rng(seed)
    if kind == "random":
        start = rng.uniform(0, 100, (b, k))
        length = rng.uniform(0.5, 30, (b, k))
    elif kind == "grid":
        start = rng.integers(0, 16, (b, k)).astype(np.float64)
        length = rng.integers(0, 6, (b, k)).astype(np.float64)
    elif kind == "chain":
        start = np.tile(np.arange(k, dtype=np.float64), (b, 1))
        length = np.full((b, k), 1.5 * (1 + thr) / (1 - thr))
    else:
        raise KeyError(f"no kind {kind!r}; there are {SWEEP_KINDS}")
    start = start.astype(np.float32)
    return np.stack([start, start + length.astype(np.float32)], -1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="temporal NMS alone")
    p.add_argument("--batch-size", type=int, default=48)
    p.add_argument("--top-k", type=int, default=48)
    p.add_argument("--iters", type=int, default=96,
                   help="chained calls per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import call_row, perturb_first, print_row
    from drn_tpu_torch.evaluate import resolve_device
    from drn_tpu_torch.ops.nms import batched_temporal_nms

    dev = resolve_device(args.device)
    rows = {"fori_single": fori_single, "package": batched_temporal_nms}
    for name, (segs, scores) in make_inputs(args.batch_size,
                                            args.top_k).items():
        segs = torch.from_numpy(segs).to(dev)
        scores = torch.from_numpy(scores).to(dev)
        want = batched_temporal_nms(segs, scores, THRESHOLD)
        for row, fn in rows.items():
            run = lambda s, c, fn=fn: fn(s, c, THRESHOLD)
            rec = {"probe": "nms_probe", "row": row, "input": name,
                   "batch_size": args.batch_size, "top_k": args.top_k,
                   **call_row(run, (segs, scores), args.iters, dev,
                              perturb=perturb_first, unit="us")}
            if row != "package":
                got = run(segs, scores)
                rec["same_as_package"] = all(
                    torch.equal(g, w) for g, w in zip(got, want))
            print_row(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
