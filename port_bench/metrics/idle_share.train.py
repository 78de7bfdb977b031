"""Share of the traced training window in which nothing ran on the device:
1 − (union of kernel, copy and set intervals) / the window's wall time,
both from the trace that records the device alone."""


def read(w):
    busy = w.timing.busy_s
    return 100.0 * (1.0 - busy / w.window_s) if busy > 0 else None
