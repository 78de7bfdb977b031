"""Device ms a step of the kernels launched inside the program's loss
(`drn.train.loss`: target assignment and `drn_loss`'s terms)."""

from port_bench import spans


def read(w):
    return spans.span_ms(w, "drn.train.loss")
