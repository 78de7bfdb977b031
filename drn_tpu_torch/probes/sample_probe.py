"""The IoU head's temporal sampling, by gather or by one-hot matmuls (port
of scripts/sample_probe.py).

    python -m drn_tpu_torch.probes.sample_probe            # flat shapes
    python -m drn_tpu_torch.probes.sample_probe --config tacos_c3d
    python -m drn_tpu_torch.probes.sample_probe --device cpu \\
        --shape 2,16,8 --iters 1                              # a rehearsal

Five samplers of (B, T, D) features at (B, N) fractional positions, each
the linear interpolation of the two rows around a position:

  - `gather (port production)`: `gather_sample`, two row gathers and an
    fp32 lerp; what the port's IoU head runs
    (`models/layers.py::linear_time_sample`, equal to it);
  - `stacked-sel (JAX production)`: `stacked_sel_sample`, the JAX
    package's `linear_time_sample`: the two one-hot (B, N, T) selections
    stacked, one batched matmul, the fp32 lerp;
  - `shared-sel+shift`: `shared_sel_sample`, one selection applied to the
    features and to them shifted up one row;
  - `onehot bf16`, `onehot fp32`: `onehot_sample`, the (B, N, T)
    interpolation matrix with the two weights in it, one batched matmul in
    that type (bf16 rounds the weights and the output; fp32 runs on CUDA
    cores, TF32 being off in the port).

The matmuls are plain `torch.einsum` / `bmm` calls, as the JAX script's
are `jnp.einsum`. Two shape sets: flat (`--shape`, default B=384,
N=T=112, D=512, bf16 features, 3N positions a row); or, with `--config`,
per level at a registry config's eval shapes, 3·T_l positions a level
(the JAX IoU head's blocked sampling). Each row (`bench.call_row`): the
host clock's time a call of a chain of `--iters` calls, with `clamped`;
the device time a call from a profiler trace (summed and union); the
kernels a call; and `max_err`, the largest difference from `gather` over
the outputs, against `tol`: 0 for the exact samplers' fp32 sums of one
nonzero product (`BF16_REL` of the features' largest magnitude for
`onehot bf16`, `FP32_REL` for `onehot fp32`). One JSON line a row on
stdout. Runs on `cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# onehot bf16 against gather: each of the two weights rounded to bf16
# (2^-9 relative, each times a feature) and the output rounded once more
# (2^-9 of a value no larger than the largest feature): 1.5·2^-8 of the
# features' largest magnitude at most; 2^-7 of it is the tolerance.
BF16_REL = 2 ** -7
# onehot fp32: the same two products summed in fp32, by another unit.
FP32_REL = 1e-6


def gather_sample(feat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    t = feat.shape[1]
    pos = pos.clamp(0.0, t - 1.0)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=t - 1)
    w = (pos - lo.to(pos.dtype))[..., None]
    take = lambda i: torch.gather(feat, 1, i[..., None].expand(
        -1, -1, feat.shape[-1]))
    return take(lo) * (1.0 - w) + take(hi) * w


def onehot_sample(feat: torch.Tensor, pos: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    t = feat.shape[1]
    pos = pos.clamp(0.0, t - 1.0)
    lo = pos.floor()[..., None]
    w = pos[..., None] - lo
    grid = torch.arange(t, dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    m = (torch.where(grid == lo, 1.0 - w, zero)
         + torch.where(grid == (lo + 1).clamp(max=t - 1), w, zero))
    return torch.bmm(m.to(dtype), feat.to(dtype))


def _lo_hi_w(t: int, pos: torch.Tensor):
    pos = pos.clamp(0.0, t - 1.0)
    lo = pos.floor()
    return lo, (lo + 1.0).clamp(max=t - 1.0), (pos - lo)[..., None].float()


def stacked_sel_sample(feat: torch.Tensor, pos: torch.Tensor):
    t = feat.shape[1]
    lo, hi, w = _lo_hi_w(t, pos)
    grid = torch.arange(t, dtype=pos.dtype, device=pos.device)
    sel = torch.stack([grid == lo[..., None], grid == hi[..., None]]
                      ).to(feat.dtype)                       # (2, B, N, T)
    f = torch.einsum("sbnt,btd->sbnd", sel, feat)
    return f[0] * (1.0 - w) + f[1] * w


def shared_sel_sample(feat: torch.Tensor, pos: torch.Tensor):
    t = feat.shape[1]
    lo, _, w = _lo_hi_w(t, pos)
    grid = torch.arange(t, dtype=pos.dtype, device=pos.device)
    sel = (grid == lo[..., None]).to(feat.dtype)             # (B, N, T)
    shifted = torch.cat([feat[:, 1:], feat[:, -1:]], dim=1)
    f = torch.einsum("bnt,sbtd->sbnd", sel, torch.stack([feat, shifted]))
    return f[0] * (1.0 - w) + f[1] * w


SAMPLERS = {
    "gather (port production)": (gather_sample, 0.0),
    "stacked-sel (JAX production)": (stacked_sel_sample, 0.0),
    "shared-sel+shift": (shared_sel_sample, 0.0),
    "onehot bf16": (lambda f, p: onehot_sample(f, p, torch.bfloat16),
                    BF16_REL),
    "onehot fp32": (lambda f, p: onehot_sample(f, p, torch.float32),
                    FP32_REL),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the IoU head's sampling, by "
                                            "gather or by one-hot matmuls")
    p.add_argument("--config", default=None,
                   help="per level at a registry config's eval shapes "
                        "instead of the flat shapes")
    p.add_argument("--shape", default="384,112,512",
                   help="flat shapes B,T,D (N=T positions of each kind)")
    p.add_argument("--iters", type=int, default=24,
                   help="chained calls per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import call_row, print_row
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        dev, torch.bfloat16)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    if args.config:
        cfg = get_config(args.config)
        b, d = cfg.eval.batch_size, cfg.model.hidden_dim
        sizes = [cfg.data.num_clips // 2 ** l
                 for l in range(cfg.model.num_levels)]
        feats = [bf16(rng.normal(size=(b, t, d))) for t in sizes]
        pos = [f32(rng.uniform(0, t - 1, size=(b, 3 * t))) for t in sizes]
        shape = {"config": cfg.name, "batch_size": b, "sizes": sizes, "D": d}
    else:
        b, t, d = (int(v) for v in args.shape.split(","))
        feats = [bf16(rng.normal(size=(b, t, d)))]
        pos = [f32(rng.uniform(0, t - 1, size=(b, 3 * t)))]
        shape = {"batch_size": b, "N": t, "T": t, "D": d}
    scale = max(f.abs().max().item() for f in feats)

    with torch.no_grad():
        want = [gather_sample(f, q).float() for f, q in zip(feats, pos)]
        for name, (sample, rel) in SAMPLERS.items():
            run = lambda fs, sample=sample: [sample(f, q)
                                             for f, q in zip(fs, pos)]
            err = max((g.float() - w).abs().max().item()
                      for g, w in zip(run(feats), want))
            print_row({"probe": "sample_probe", "row": name, **shape,
                       "max_err": err, "tol": rel * scale,
                       **call_row(run, (feats,), args.iters, dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
