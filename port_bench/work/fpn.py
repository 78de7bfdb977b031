"""Temporal FPN: a k=1 lateral and a k=3 smoothing block a level."""

from port_bench import workcount as w


def forward(dims, batch: int):
    d = dims["hidden_dim"]
    return w.total([w.conv(batch, t, d, d, 1, t) for t in w.sizes(dims)]
                   + [w.conv(batch, t, d, d, 3, t) for t in w.sizes(dims)])


def train(dims, batch: int, stage: int = 1):
    return w.trained(forward(dims, batch), with_grad=stage == 1)
