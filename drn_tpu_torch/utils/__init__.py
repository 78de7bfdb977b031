"""Utilities of the port: metric logging, checkpoints, FLOP counts,
timing and profiling, numerical sanitizers."""
