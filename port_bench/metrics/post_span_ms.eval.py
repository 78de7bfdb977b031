"""Device ms a step of the kernels launched inside the program's own
post-processing range (`drn.eval.post`): scoring, the stable sort and
top-k, NMS, recall and the seconds' scaling."""

from port_bench import spans


def read(w):
    return spans.span_ms(w, "drn.eval.post")
