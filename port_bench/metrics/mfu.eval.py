"""Model operations of the valid queries graded in the traced window (the
sum of work/*.py a query) over the window's seconds and the bf16 peak, in
%."""


def read(w):
    if not w.timing.kernels:
        return None
    flops = w.model_work()["flops"] * w.units
    return 100.0 * flops / w.window_s / w.peak_flops
