"""Grounding heads: two towers of k=3 conv blocks over the levels'
gap-padded concat (sum of level sizes + levels − 1 positions), then k=3
output convs of 2 (distances) and 1 (match) channels."""

from port_bench import workcount as w


def forward(dims, batch: int):
    d, levels = dims["hidden_dim"], dims["num_levels"]
    g = sum(w.sizes(dims)) + levels - 1
    towers = [w.conv(batch, g, d, d, 3, g)
              for _ in range(2 * dims["head_tower_layers"])]
    outs = [w.conv(batch, g, d, c, 3, g, out_bytes=w.FP32) for c in (2, 1)]
    return w.total(towers + outs)


def train(dims, batch: int, stage: int = 1):
    return w.trained(forward(dims, batch), with_grad=stage == 1)
