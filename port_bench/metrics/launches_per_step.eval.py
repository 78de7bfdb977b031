"""Kernels a step of the eval loop launches (all of the trace's kernels
over the window's steps; the trace was checked against the port's own
launch counter). Moves eval_qps: the host launches every one."""


def read(w):
    k = w.timing.kernels
    return len(k) / w.steps if k else None
