"""The map convs' gains of the 2D-TAN configuration
(`assumed.map_conv_gains` of configs/tacos_2dtan_c3d.json), derived on the
CPU:

    python3 -m port_bench.tan_gains [--width 64] [--seed 7]
    python3 -m port_bench.tan_gains --check --width 512 --device cuda

The reference's layers at the configuration's map and kernel, at
`--width` channels (every weight is z / sqrt(fan_in), so the gains hardly
move with the width), each gain fixed so that the map's spread across the
valid moments (each query's and channel's mean over them taken out: what
ranks a query's moments) equals its input's, on a few random queries;
prints the gains and, with the gains rounded, each layer's ratio of that
spread and of the root mean square over its live cells. `--check` prints
the ratios of the configuration's own gains.

The readings behind the cell's limits (the program's numbers, the fp8
control, the faults) come from the entry itself (entries/tan_eval.py:
`run`, `run(ctx, fault)` for each of its FAULTS, `control`); one module
for every entry's readings is port_bench/control.py's to become.
"""

from __future__ import annotations

import argparse
import json

import torch

from port_bench import gen, spec
from port_bench.reference import model as ref
from port_bench.reference import tan as ref_tan


def _spread(x, at):
    """Root mean square over the moments `at` of x (B, C, H, W) less each
    query's and channel's mean over them: what ranks a query's moments."""
    v = x[:, :, at[0], at[1]]
    return float((v - v.mean(2, keepdim=True)).pow(2).mean().sqrt())


def _rms(x, live):
    return float(x.pow(2).sum() / (live.sum() * x.shape[0] * x.shape[1])) \
        ** 0.5


def gains(conf: dict, width: int, queries: int = 4, seed: int = 7,
          rounds: int = 24, fixed=None, device="cpu"):
    """→ (gains, spread ratios, live-cell ratios). Each map conv's gain (a
    bisection of its log) keeps the spread of the map across the valid
    moments (`_spread`, read where each layer's output lies over them) at
    its input's; the ratios are each layer's output over its input with
    the gains rounded to 2 decimals: of that spread, and of the root mean
    square over the live cells. The input is the reference's fusion of
    random clips and queries at `width` channels. With `fixed` gains,
    only the ratios of those."""
    from drn_tpu_torch.config import TANModelConfig
    from drn_tpu_torch.models.tan import TAN

    dims = {**spec.dims(conf), "hidden_dim": width}
    mcfg = TANModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in conf["model"].items()
                             if k != "hidden_dim"}, hidden_dim=width)
    shapes = {k: tuple(v.shape) for k, v in
              TAN(mcfg, dims["num_clips"]).state_dict().items()}
    p = gen.weights(shapes, seed, device)
    n, k = ref_tan.map_size(dims), dims["map_kernel_size"]
    mask = ref_tan.valid_mask(n, dims["scale_layers"])
    weights = [w.to(device) for w in
               ref_tan.count_weights(mask, k, dims["map_paddings"])]
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(queries, dims["num_clips"], dims["feature_dim"],
                        generator=g).to(device)
    words = torch.randint(2, dims["vocab_size"],
                          (queries, dims["max_query_len"]),
                          generator=g).to(device)
    with torch.no_grad(), ref.fp32_mode():
        txt = ref_tan.query(p, dims, words, torch.ones_like(words).bool())
        m = ref_tan.moment_map(ref_tan.clips(p, dims, feats),
                               mask.to(device))
        vis = torch.einsum("bchw,oc->bohw", m, p["vis_conv.weight"]) \
            + p["vis_conv.bias"][None, :, None, None]
        f = txt[:, :, None, None] * vis
        x = f / f.norm(dim=1, keepdim=True).clamp_min(ref_tan.EPS) \
            * mask.to(device)
    at = tuple(i.to(device) for i in torch.nonzero(mask, as_tuple=True))
    found, spreads, rmss = [], [], []
    x_r, live, shift = x, mask.float().to(device), 0
    for l, pad in enumerate(dims["map_paddings"]):
        w_l = p[f"map_conv.convs.{l}.weight"]
        b_l = p[f"map_conv.convs.{l}.bias"]
        here = (at[0] + shift + pad - k // 2, at[1] + shift + pad - k // 2)

        def layer(inp, gain):
            with torch.no_grad(), ref.fp32_mode():
                return torch.relu(torch.nn.functional.conv2d(
                    inp, w_l * gain, b_l, padding=pad)) * weights[l]

        before = (at[0] + shift, at[1] + shift)
        lo, hi = 0.0, 4.0   # log10 of the gain: the spread rises with it
        for _ in range(0 if fixed else rounds):
            mid = 0.5 * (lo + hi)
            if _spread(layer(x, 10 ** mid), here) < _spread(x, before):
                lo = mid
            else:
                hi = mid
        gain = fixed[l] if fixed else 10 ** (0.5 * (lo + hi))
        found.append(round(gain, 2))
        y_r = layer(x_r, found[-1])
        out_live = (weights[l] > 0).float()
        spreads.append(_spread(y_r, here) / _spread(x_r, before))
        rmss.append(_rms(y_r, out_live) / _rms(x_r, live))
        x, x_r, live = layer(x, gain), y_r, out_live
        shift += pad - k // 2
    return found, spreads, rmss


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="tacos.tan_eval.b128")
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--check", action="store_true",
                   help="the ratios of the configuration's gains")
    p.add_argument("--device", default="cpu", help="where to compute")
    args = p.parse_args(argv)
    cell = spec.workload(spec.benchmark(), args.workload)
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    conf = spec.config(cell["config"])
    fixed = conf["assumed"]["map_conv_gains"] if args.check else None
    found, spreads, rmss = gains(conf, args.width, seed=args.seed,
                                 fixed=fixed, device=args.device)
    print(json.dumps({"width": args.width, "seed": args.seed,
                      "gains": found,
                      "spread_ratios": [round(r, 4) for r in spreads],
                      "live_rms_ratios": [round(r, 3) for r in rmss]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
