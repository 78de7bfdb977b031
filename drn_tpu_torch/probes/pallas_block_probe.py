"""Measure the fused fusion block kernel against the same block left to
PyTorch: the port of scripts/pallas_block_probe.py.

    python -m drn_tpu_torch.probes.pallas_block_probe    # needs the card

At the probe's shapes (B=256, T=64, D=512, K=3; inputs from
numpy.random.default_rng(0), scaled as the JAX probe scales them) it
prints to stderr, as the JAX probe does:

  * numerics first: max |kernel − xla_block| (the probe's comparison, its
    bias added in bf16) and max |kernel − plain version|;
  * device times (`utils.profiling.cuda_time_ms`) of the kernel
    (`pallas_block`), its plain version, `xla_block`, and a library
    yardstick that the port never calls: `F.conv1d` (cuDNN, bf16) +
    `F.layer_norm` + ReLU, standing in for the compiler's own whole-block
    fusion that the JAX probe times against.

and one JSON line of the same numbers on stdout. The JAX probe's batch
blocks (bb ∈ {8, 16}) are the TPU's VMEM tiling and have no counterpart
here (ops/cuda/block_probe.py). Runs on `cuda` only; with no card it
raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from drn_tpu_torch.evaluate import resolve_device
from drn_tpu_torch.ops.cuda import (pallas_block, pallas_block_reference,
                                    xla_block)
from drn_tpu_torch.ops.cuda.conv_block import LN_EPS
from drn_tpu_torch.utils.profiling import cuda_time_ms

B, T, D, K = 256, 64, 512, 3


def make_inputs(b: int, t: int, d: int, k: int, device, seed: int = 0):
    """(v, q, w, bias, scale, offset) drawn in the JAX probe's order and
    scales: v, q, w, bias bf16; scale, offset fp32."""
    rng = np.random.default_rng(seed)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    return (put(rng.normal(size=(b, t, d)), bf16),
            put(rng.normal(size=(b, d)), bf16),
            put(rng.normal(size=(k, d, d)) * 0.05, bf16),
            put(rng.normal(size=(d,)) * 0.1, bf16),
            put(rng.normal(size=(d,)) * 0.2 + 1.0, f32),
            put(rng.normal(size=(d,)) * 0.1, f32))


def library_block(v, q, w, b, scale, offset, eps: float = LN_EPS):
    """The yardstick as a zero-argument callable: the same block through
    PyTorch's library calls, inputs laid out for cuDNN beforehand (v as
    (B, D, T), w as (Dout, D, K)); the conv pads K // 2 on both sides and
    keeps the first T rows, the bias added in bf16 by the conv."""
    t, k = v.shape[1], w.shape[0]
    vt = v.transpose(1, 2).contiguous()
    q3 = q[:, :, None].contiguous()
    wt = w.permute(2, 1, 0).contiguous()
    shape = (w.shape[2],)

    def run():
        y = F.conv1d(vt * q3, wt, b, padding=k // 2)[..., :t]
        y = F.layer_norm(y.transpose(1, 2).float(), shape, scale, offset, eps)
        return F.relu(y).to(v.dtype)

    return run


def run(device=None) -> dict:
    """Numerics, then device times, at the probe's shapes; returns the
    numbers."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the CUDA kernel: it runs on cuda")
    args = make_inputs(B, T, D, K, dev)
    library = library_block(*args)
    with torch.no_grad():
        out = pallas_block(*args).float()
        ref = xla_block(*args).float()
        plain = pallas_block_reference(*args).float()
        lib = library().float()
        torch.cuda.synchronize()
        res = dict(
            B=B, T=T, D=D, K=K,
            max_abs_err_vs_xla_block=(out - ref).abs().max().item(),
            max_abs_err_vs_plain=(out - plain).abs().max().item(),
            library_max_abs_err_vs_xla_block=(lib - ref).abs().max().item())
        print(f"pallas_block max|Δ| vs xla_block = "
              f"{res['max_abs_err_vs_xla_block']:.4f}, vs plain = "
              f"{res['max_abs_err_vs_plain']:.4f}", file=sys.stderr,
              flush=True)
        for key, fn in (("ms", lambda: pallas_block(*args)),
                        ("plain_ms", lambda: pallas_block_reference(*args)),
                        ("xla_block_ms", lambda: xla_block(*args)),
                        ("library_ms", library)):
            res[key] = cuda_time_ms(fn)
    for key, label in (("xla_block_ms", "xla_block (plain PyTorch)"),
                       ("library_ms", "library (cuDNN conv + layer_norm)"),
                       ("plain_ms", "plain version"),
                       ("ms", "pallas_block kernel")):
        print(f"{label:34s}: {res[key] * 1e3:9.1f} us "
              f"({res['library_ms'] / res[key]:.2f}x vs library)",
              file=sys.stderr, flush=True)
    res["device"] = torch.cuda.get_device_name(dev)
    return res


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    print(json.dumps(run("cuda")))


if __name__ == "__main__":
    main()
