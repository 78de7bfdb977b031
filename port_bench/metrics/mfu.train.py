"""Model operations of the valid examples stepped in the traced window
(forward, dX and dW of every part that gets a gradient, work/*.py `train`,
an example) over the window's seconds and the bf16 peak, in %."""


def read(w):
    if not w.timing.kernels:
        return None
    flops = w.model_work(train=True)["flops"] * w.units
    return 100.0 * flops / w.window_s / w.peak_flops
