"""Device ms a step of the kernels launched inside the optimizer's step:
the norm, clipping and Adam."""


def read(w):
    return w.per_step_ms(w.trace.in_range("pb.optimizer"))
