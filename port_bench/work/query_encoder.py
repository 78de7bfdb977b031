"""Query encoder: stacked bidirectional LSTMs over max_query_len words
(input and recurrent products of four gates), one projection a level."""

from port_bench import workcount as w


def forward(dims, batch: int):
    d, n = dims["hidden_dim"], dims["max_query_len"]
    h = d // 2
    flops = nbytes = 0.0
    for layer in range(dims["num_lstm_layers"]):
        cin = dims["embed_dim"] if layer == 0 else d
        flops += 2 * (2.0 * batch * n * (cin + h) * 4 * h)
        nbytes += 2 * w.FP32 * (batch * n * (cin + h) + (cin + h) * 4 * h)
    flops += dims["num_levels"] * 2.0 * batch * d * d
    nbytes += dims["num_levels"] * w.FP32 * (2 * batch * d + d * d)
    return {"flops": flops, "bytes": nbytes}


def train(dims, batch: int, stage: int = 1):
    """The first step's recurrent product reads the zero state, whose
    gradient nobody needs: one dX fewer a direction and layer."""
    out = w.trained(forward(dims, batch), with_grad=stage == 1)
    if stage == 1:
        h = dims["hidden_dim"] // 2
        out["flops"] -= 2 * dims["num_lstm_layers"] * 2.0 * batch * h * 4 * h
    return out
