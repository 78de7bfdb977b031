"""The backbone's bound time (work/backbone.py at the step's batch, the
larger of operations over the bf16 peak and bytes over HBM's) over the
device time of the kernels launched inside its forward, in %."""


def read(w):
    return w.roofline(w.work("backbone"), w.trace.in_range("pb.backbone"))
