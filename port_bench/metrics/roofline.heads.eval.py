"""The grounding heads' bound time (work/heads.py) over the device time of
the kernels launched inside their forward, in %."""


def read(w):
    return w.roofline(w.work("heads"), w.trace.in_range("pb.heads"))
