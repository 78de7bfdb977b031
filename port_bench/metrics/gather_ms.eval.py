"""Device ms a step of the kernels launched inside the program's gather of
the batch's rows from the staged table (`drn.eval.gather`)."""

from port_bench import spans


def read(w):
    return spans.span_ms(w, "drn.eval.gather")
