"""Tensor ops of the port: temporal segment math, NMS, metrics, kernels."""
