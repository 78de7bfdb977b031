"""IoU head: each location's level sampled at its segment's start, mid
and end (3·D channels, no products), k=1 conv blocks, a k=1 output conv."""

from port_bench import workcount as w


def forward(dims, batch: int):
    d, n = dims["hidden_dim"], sum(w.sizes(dims))
    parts = [w.conv(batch, n, 3 * d if i == 0 else d, d, 1, n)
             for i in range(dims["iou_head_layers"])]
    parts.append(w.conv(batch, n, d, 1, 1, n, out_bytes=w.FP32))
    return w.total(parts)


def train(dims, batch: int, stage: int = 1):
    """Stage 1 weights the IoU loss by 0: the head gets no gradient, and its
    backward is no model work."""
    return w.trained(forward(dims, batch), with_grad=stage >= 2)
