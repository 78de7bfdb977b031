"""Device ms a step of the kernels launched after the DRN forward returns
and before the next host-device copy: scoring, the stable sort and top-k,
NMS, recall and the counts' accumulation."""


def read(w):
    return w.per_step_ms(w.trace.after_forward())
