"""Backbone: input LayerNorm and stem conv (fp32 features in), then one
k=3 conv block a level, strides 1, 2, 2, ..."""

from port_bench import workcount as w


def forward(dims, batch: int):
    t, f, d = dims["num_clips"], dims["feature_dim"], dims["hidden_dim"]
    parts = [w.conv(batch, t, f, d, 3, t, in_bytes=w.FP32)]
    t_in = t
    for t_out in w.sizes(dims):
        parts.append(w.conv(batch, t_out, d, d, 3, t_in))
        t_in = t_out
    return w.total(parts)


def train(dims, batch: int, stage: int = 1):
    """The input LayerNorm's parameters need the stem's dX too."""
    return w.trained(forward(dims, batch), with_grad=stage == 1)
