"""Kernels a training step launches, forward, backward and optimizer."""


def read(w):
    k = w.timing.kernels
    return len(k) / w.steps if k else None
