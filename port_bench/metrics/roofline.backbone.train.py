"""The backbone's forward, dX and dW work (work/backbone.py `train`, not
the recompute) over the device time of the kernels that ran it: those
launched inside its forward and by the backward nodes of the ops its
forward ran, in %."""


def read(w):
    fwd = w.trace.in_range("pb.backbone")
    bwd = w.trace.backward_of("pb.backbone")
    if not fwd or not bwd:
        return None
    return w.roofline(w.work("backbone", train=True), fwd + bwd)
