"""The benchmark of `drn_tpu_torch`, the PyTorch and CUDA port, on one
NVIDIA H100: cells named in the repository's BENCHMARK.json, each a
configuration (configs/) under a traffic mix (traffic/) driven by an entry
(entries/), checked against a plain fp32 reference (reference/), with
per-layer metrics read from a profiler trace (metrics/, work/). See
run.py for the command, PERF.md for the cells and their limits.

Nothing here imports JAX or the JAX package; reference/ imports nothing
of the program either.
"""
