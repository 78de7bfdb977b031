"""Fusion: per level, a k=fusion_kernel_size conv block on v ⊙ q."""

from port_bench import workcount as w


def forward(dims, batch: int):
    d, k = dims["hidden_dim"], dims["fusion_kernel_size"]
    return w.total(w.conv(batch, t, d, d, k, t) for t in w.sizes(dims))


def train(dims, batch: int, stage: int = 1):
    return w.trained(forward(dims, batch), with_grad=stage == 1)
