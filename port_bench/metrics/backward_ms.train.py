"""Device ms a step of the kernels launched, on any thread, while the
program's backward range (`drn.train.backward`) was open: the recompute
backward through the kernels' autograd, on autograd's own thread."""

from port_bench import spans


def read(w):
    return spans.span_ms(w, "drn.train.backward")
