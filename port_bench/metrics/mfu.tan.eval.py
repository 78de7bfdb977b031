"""2D-TAN's live operations of the valid queries graded in the traced
window (work/_tan.py `forward` a query: the map convs' live products, the
LSTM, the frame, fusion and prediction convs) over the window's seconds
and the bf16 peak, in %."""

from port_bench import spec


def read(w):
    if not w.timing.kernels:
        return None
    flops = spec.work("_tan").forward(w.dims, 1)["flops"] * w.units
    return 100.0 * flops / w.window_s / w.peak_flops
