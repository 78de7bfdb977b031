"""Device ms a step of the kernels launched inside the query encoder's
forward (the `pb.query_encoder` range)."""


def read(w):
    return w.per_step_ms(w.trace.in_range("pb.query_encoder"))
