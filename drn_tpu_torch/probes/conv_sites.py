"""Where the time of csrc/conv_sm90.cuh's kernels goes, site by site, on
the card: conv_ln_relu's and the fusion kernels' (its Hadamard variant).

    python -m drn_tpu_torch.probes.conv_sites             # splits
    python -m drn_tpu_torch.probes.conv_sites --trees A B  # whole wrappers

Splits: every conv_ln_relu launch of the flagship
(charades_c3d_batched_eval) eval step (B=48) and train-step forward
(B=384), and every pyramid level of `fused_fusion_block` and
`fused_fusion` at both batches, with each split of a row tile's columns
over a cluster that csrc/conv_sm90.cuh builds and whose blocks fit the
card's SMs at once (`conv_block.CONV_SPLITS`), launched through the C
entry point with that split forced; device time
(`utils.profiling.cuda_time_ms`), achieved TFLOP/s, and the split
`conv_plan` picks.

Trees: the whole `conv_ln_relu` wrapper of each directory given (a checkout
of the repository, e.g. `git archive` of an earlier commit), each run in a
process of its own, in turns A B ... B A: device time at each eval site
and at each fusion level of both fusion kernels at both batches, and the
conv wrapper's host time per call (`utils.profiling.host_ms`, 300
pipelined calls at B=1, T=16, where the kernel is shorter than the call).

One JSON line per site (per tree: per run) on stdout. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CONFIG = "charades_c3d_batched_eval"
BATCHES = (48, 384)  # the config's eval and training batches

# One process per tree: the tree's own package, the same inputs.
TIMER = """
import json, sys, torch
sys.path.insert(0, ".")
from drn_tpu_torch.ops.cuda import conv_block as cb
from drn_tpu_torch.utils.profiling import cuda_time_ms, host_ms
g = torch.Generator(device="cuda").manual_seed(0)
r = lambda *s, k=1.0: torch.randn(*s, device="cuda", generator=g) * k
for site, b, t, cin, k, stride, norm, act in %r:
    args = (r(b, t, cin).bfloat16(), r(k, cin, 512, k=(k * cin) ** -0.5)
            .bfloat16(), r(512, k=0.1), 1 + r(512, k=0.1), r(512, k=0.1),
            stride, norm, act)
    with torch.no_grad():
        ms = cuda_time_ms(lambda: cb.conv_ln_relu(*args))
    print(json.dumps(dict(site=site, B=b, ms=ms)))
from drn_tpu_torch.ops.cuda import fused_fusion as ff
for site, b, t, d, k in %r:
    name = site.split(":")[0]
    args = (r(b, t, d).bfloat16(), r(b, d, k=0.5).bfloat16(),
            r(k, d, d, k=(k * d) ** -0.5).bfloat16(), r(d, k=0.1))
    if name == "fused_fusion_block":
        args += (1 + r(d, k=0.1), r(d, k=0.1))
    with torch.no_grad():
        ms = cuda_time_ms(lambda: getattr(ff, name)(*args))
    print(json.dumps(dict(site=site, B=b, ms=ms)))
x, w = r(1, 16, 512).bfloat16(), r(3, 512, 512, k=0.03).bfloat16()
v = r(512, k=0.1)
with torch.no_grad():
    print(json.dumps(dict(site="host", B=1, ms=host_ms(
        lambda: cb.conv_ln_relu(x, w, v, 1 + v, v), 300))))
"""


def sites(batches=BATCHES):
    """(site, B, T_in, Cin, K, stride, use_norm, use_act) of the flagship's
    conv_ln_relu launches at each batch."""
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.models.drn import conv_block_sites

    cfg = get_config(CONFIG)
    return [(s[0], b, *s[1:]) for b in batches
            for s in conv_block_sites(cfg.model, cfg.data.num_clips)]


def fusion_sites(batches=BATCHES):
    """(site, B, T, D, K) of the flagship's fusion launches at each batch:
    `fused_fusion_block` and `fused_fusion` at each pyramid level, the
    site named `<kernel>:level_<l>`."""
    from drn_tpu_torch.config import get_config

    cfg = get_config(CONFIG)
    m = cfg.model
    return [(f"{name}:level_{l}", b, cfg.data.num_clips // 2 ** l,
             m.hidden_dim, m.fusion_kernel_size)
            for b in batches for name in ("fused_fusion_block", "fused_fusion")
            for l in range(m.num_levels)]


def splits() -> None:
    import torch

    from drn_tpu_torch.ops.cuda import _build
    from drn_tpu_torch.ops.cuda import conv_block as cb
    from drn_tpu_torch.utils.profiling import cuda_time_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, k=1.0: torch.randn(*s, device="cuda", generator=g) * k
    d = 512

    def report(site, b, m, flops, launch):
        """`launch(split, grid)` timed at each built split whose blocks fit
        the SMs; the site's line."""
        tiles = -(-m // cb.TILE_ROWS)
        ms = {s: cuda_time_ms(lambda: launch(s, s * tiles))
              for s in cb.CONV_SPLITS[d] if s == 1 or s * tiles <= sms}
        print(json.dumps(dict(
            site=site, B=b, tiles=tiles, ms_by_split=ms,
            tflops_by_split={s: flops / v / 1e9 for s, v in ms.items()},
            plan=cb.conv_plan(m, d, sms).split)), flush=True)

    def check(rc):
        if rc:
            raise RuntimeError(f"conv_sites: CUDA error {rc}")

    fn = _build.entry("conv_block", "drn_conv_ln_relu", 6, 12)
    for site, b, t, cin, k, stride, norm, act in sites():
        x = r(b, t, cin).bfloat16()
        w = r(k, cin, d, k=(k * cin) ** -0.5).bfloat16()
        bias, scale, offset = r(d, k=0.1), 1 + r(d, k=0.1), r(d, k=0.1)
        out_t, left, _ = cb.same_padding(t, k, stride)
        out = torch.empty((b, out_t, d), dtype=torch.bfloat16, device="cuda")
        report(site, b, b * out_t, 2 * b * out_t * k * cin * d,
               lambda split, grid: check(fn(
                   x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                   scale.data_ptr(), offset.data_ptr(), out.data_ptr(), b, t,
                   cin, d, k, stride, out_t, left, int(norm), int(act), split,
                   grid, cb.stream_of(x))))

    for site, b, t, _, k in fusion_sites():
        name = site.split(":")[0]
        v, q = r(b, t, d).bfloat16(), r(b, d, k=0.5).bfloat16()
        w = r(k, d, d, k=(k * d) ** -0.5).bfloat16()
        epi = (r(d, k=0.1), 1 + r(d, k=0.1), r(d, k=0.1))
        if name == "fused_fusion":
            epi = epi[:1]  # the bias alone
        out = torch.empty((b, t, d), dtype=torch.bfloat16, device="cuda")
        ptrs = [a.data_ptr() for a in (v, q, w, *epi, out)]
        fn = _build.entry("fused_fusion", "drn_" + name, len(ptrs), 7)
        report(site, b, b * t, 2 * b * t * k * d * d,
               lambda split, grid: check(fn(*ptrs, b, t, d, d, k, split,
                                            grid, cb.stream_of(v))))


def trees(dirs) -> None:
    code = TIMER % (sites(BATCHES[:1]), fusion_sites())
    times = {dd: [] for dd in dirs}
    for dd in list(dirs) + list(reversed(dirs)):
        out = subprocess.run([sys.executable, "-c", code], cwd=dd,
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"conv_sites: {dd} failed:\n{out.stderr}")
        times[dd].append([json.loads(line) for line in out.stdout.split("\n")
                          if line.startswith("{")])
    for i, row in enumerate(times[dirs[0]][0]):
        print(json.dumps(dict(site=row["site"], B=row["B"], ms_by_tree={
            dd: [run[i]["ms"] for run in runs]
            for dd, runs in times.items()})), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=None,
                    help="checkouts whose whole conv_ln_relu to time in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("conv_sites: needs a CUDA device")
    trees(args.trees) if args.trees else splits()
    return 0


if __name__ == "__main__":
    sys.exit(main())
