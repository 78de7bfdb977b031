"""2D-TAN's operations and bytes (configs/tacos_2dtan_c3d.json), counting
only the work its masks leave live: no kernel that computes the model
exactly can do less.

The map convs: a product counts where both its input cell (live in the
previous layer's mask, the zero padding dead) and its output cell (live
after the layer) are live: for every live output cell, the live input
cells of its window, 2·D·D operations each. Bytes: each live input and
output cell's D channels in bf16, the layer's weights in bf16. The 1×1
convs count their live cells alone (the fusion's and the prediction's at
the valid moments).

The leading `_` keeps this file out of `spec.parts()`: DRN's part sums
(`Window.model_work`, the `mfu.*` of its cells) never read it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import torch

from port_bench import workcount as w
from port_bench.reference import tan


@lru_cache(maxsize=None)
def _layers(n: int, scale_layers: Tuple[int, ...], kernel: int,
            paddings: Tuple[int, ...]) -> List[Tuple[int, int, int]]:
    """(live input cells, live-live taps, live output cells) a layer."""
    live = tan.valid_mask(n, scale_layers).float()
    out = []
    for weight in tan.count_weights(live.bool(), kernel, paddings):
        alive = weight > 0
        taps = torch.round(1.0 / weight[alive]).sum()   # w = 1 / count
        out.append((int(live.sum()), int(taps), int(alive.sum())))
        live = (weight > 0).float()
    return out


def layers(dims) -> List[Tuple[int, int, int]]:
    return _layers(tan.map_size(dims), tuple(dims["scale_layers"]),
                   dims["map_kernel_size"], tuple(dims["map_paddings"]))


def live_cells(dims) -> int:
    """Live output cells of the map convs a query, summed over layers."""
    return sum(o for _, _, o in layers(dims))


def computed_cells(dims) -> int:
    """Output cells of the dense map convs a query."""
    n, k = tan.map_size(dims), dims["map_kernel_size"]
    total = 0
    for p in dims["map_paddings"]:
        n = n + 2 * p - k + 1
        total += n * n
    return total


def map_conv(dims, batch: int) -> Dict[str, float]:
    d, k = dims["hidden_dim"], dims["map_kernel_size"]
    flops = nbytes = 0.0
    for cin, taps, cout in layers(dims):
        flops += 2.0 * batch * taps * d * d
        nbytes += (batch * (cin + cout) * d + k * k * d * d) * w.BF16
    return {"flops": flops, "bytes": nbytes}


def moments(dims) -> int:
    return int(tan.valid_mask(tan.map_size(dims), dims["scale_layers"]).sum())


def forward(dims, batch: int) -> Dict[str, float]:
    """The whole model's live work: the LSTM (every word slot, as cuDNN
    runs them), the projection, the frame conv at every clip, the fusion's
    1×1 conv and the prediction at the valid moments, the map convs."""
    d, f, t = dims["hidden_dim"], dims["feature_dim"], dims["num_clips"]
    words, k = dims["max_query_len"], moments(dims)
    parts = [map_conv(dims, batch),
             w.conv(batch, t, f, d, 1, t, in_bytes=w.FP32),
             w.conv(batch, k, d, d, 1, k),
             w.conv(batch, k, d, 1, 1, k, out_bytes=w.FP32)]
    for layer in range(dims["num_lstm_layers"]):
        cin = dims["embed_dim"] if layer == 0 else d
        parts.append({"flops": 2.0 * batch * words * (cin + d) * 4 * d,
                      "bytes": w.FP32 * (batch * words * (cin + d)
                                         + (cin + d) * 4 * d)})
    parts.append({"flops": 2.0 * batch * d * d,
                  "bytes": w.FP32 * (2 * batch * d + d * d)})
    return w.total(parts)
