"""Does a low-precision product beat bf16 at the stem's shape? (port of
scripts/int8_probe.py, asked of Hopper's int8 and FP8 tensor cores)

    python -m drn_tpu_torch.probes.int8_probe        # (3072, 12288) x (12288, 512)
    python -m drn_tpu_torch.probes.int8_probe --device cpu \\
        --shape 64,384,64 --iters 1                            # a rehearsal

The product is the stem's unfolded k=3 conv over C3D features at the
eval batch: (B·T, 3·4096) × (3·4096, 512), fp32 operands drawn from
seed 0. Rows, each a body with its casts and quantization on the clock
as in the JAX bodies:

  - `bf16`: both operands cast to bf16, one product (fp32 accumulation,
    the output rounded to bf16: PyTorch's bf16 matmul returns bf16);
  - `int8`: dynamic symmetric scales, per row of A and per column of W
    (max|x| / 127, round half to even, clip to ±127), the int8 product
    with int32 accumulators (`torch._int_mm`), rescaled in fp32;
  - `int8_prequantized`: W quantized once beforehand (the serving case);
    only A's quantization is on the clock;
  - `fp8`, `fp8_prequantized`: the same with float8 e4m3 (max|x| / 448),
    the product by `torch._scaled_mm` with the per-row and per-column
    scales (bf16 output);
  - `bf16_product`, `int8_product`, `fp8_product`: the product alone, on
    operands cast beforehand, so that the casts' cost shows.

A plain large product stays a library call here, as the JAX script's is
an XLA dot outside any Pallas kernel. Each row is timed by
`bench.chained_time` over a `bench.CallChain` of 1 and 1 + `--iters`
calls; in eager PyTorch no call is hoisted out of the chain, so the
operands pass unperturbed (an `a + 0·s` would add a full pass over the
151 MB A to every call, which XLA fused into the JAX bodies' casts), and
each call's output is consumed by one fp32 sum. A row gives µs a product,
TFLOP/s-equivalent (2·m·k·n over its time), its share of the H100 SXM's
dense peak for its type (989 TFLOP/s bf16, 1,979 TOP/s int8 and FP8),
its bound (the larger of those operations at that peak and its inputs
read once and output written once at 3.35 TB/s), its relative error
(Frobenius) against the fp32 product, and its speedup over `bf16` (the
product rows: over `bf16_product`). The `int8` row also holds the int32
accumulators against a plain version: the same int8 operands multiplied
in float64, exact here (|sum| ≤ 127² · k < 2^53), so they must be equal
(`acc_equal`, `acc_mismatches`). One JSON line a row on stdout. Runs on
`cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np
import torch

SHAPE = (48 * 64, 3 * 4096, 512)  # (B·T, 3·F, D) of the eval step's stem
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12}  # H100 SXM
PEAK_BYTES_PER_S = 3.35e12
INT8_MAX = 127.0
FP8_MAX = 448.0  # float8 e4m3fn's largest finite value
# The rescaled outputs against the fp32 product, relative Frobenius
# error. bf16 rounds each operand to 8 significant bits (~3e-3 on seed 0's
# normal draws) and int8 to steps of max|x| / 127 (~1.3e-2 at k=12288,
# where max|x| is ~4.2 standard deviations); e4m3 keeps 3 mantissa bits:
# a relative rounding of up to 2^-4 an operand, ~2.6e-2 rms on such draws,
# the two operands' in quadrature ~3.7e-2. Each bound is about 1.5x that.
REL_TOL = {"bf16": 2e-2, "int8": 2e-2, "fp8": 6e-2}


def quantize_int8(x: torch.Tensor, dim: int):
    """(int8 values, fp32 scales): symmetric, max|x| / 127 along `dim`
    (1: a scale a row; 0: a scale a column), as the JAX bodies."""
    s = x.abs().amax(dim=dim, keepdim=True) / INT8_MAX
    q = torch.clamp(torch.round(x / s), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), s


def quantize_fp8(x: torch.Tensor, dim: int):
    """(float8 e4m3 values, fp32 scales): max|x| / 448 along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True) / FP8_MAX
    return (x / s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn), s


def column_major(t: torch.Tensor) -> torch.Tensor:
    """`t` laid out column by column (the second operand's layout that the
    card's int8 and FP8 products take)."""
    return t.t().contiguous().t()


def int8_product(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The int8 product's int32 accumulators."""
    return torch._int_mm(qa, qw)


def fp8_product(qa, qw, sa, sw) -> torch.Tensor:
    """The e4m3 product with per-row and per-column scales, bf16 out."""
    return torch._scaled_mm(qa, qw, scale_a=sa, scale_b=sw,
                            out_dtype=torch.bfloat16)


def bf16_body(a, w):
    return torch.mm(a.to(torch.bfloat16), w.to(torch.bfloat16)).float()


def int8_body(a, w):
    qa, sa = quantize_int8(a, 1)
    qw, sw = quantize_int8(w, 0)
    return int8_product(qa, column_major(qw)).float() * sa * sw


def int8_prequantized_body(a, qw, sw):
    qa, sa = quantize_int8(a, 1)
    return int8_product(qa, qw).float() * sa * sw


def fp8_body(a, w):
    qa, sa = quantize_fp8(a, 1)
    qw, sw = quantize_fp8(w, 0)
    return fp8_product(qa, column_major(qw), sa, sw).float()


def fp8_prequantized_body(a, qw, sw):
    qa, sa = quantize_fp8(a, 1)
    return fp8_product(qa, qw, sa, sw).float()


def consume(out: torch.Tensor) -> torch.Tensor:
    """A call's output read once into the chain's scalar."""
    return out.sum(dtype=torch.float32) * 1e-9


def keep(args, s):
    return args


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.double() - ref.double()).norm() / ref.double().norm()
            ).item()


def rows_of(a: torch.Tensor, w: torch.Tensor) -> Dict[str, tuple]:
    """{row: (type, timed function, its arguments, the function giving the
    row's fp32 output)}: the bodies and the products alone."""
    qw8, sw8 = quantize_int8(w, 0)
    qw8 = column_major(qw8)
    qf8, sf8 = quantize_fp8(w, 0)
    qf8 = column_major(qf8)
    qa8, sa8 = quantize_int8(a, 1)
    qaf, saf = quantize_fp8(a, 1)
    ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
    return {
        "bf16": ("bf16", bf16_body, (a, w), None),
        "int8": ("int8", int8_body, (a, w), None),
        "int8_prequantized": ("int8", int8_prequantized_body,
                              (a, qw8, sw8), None),
        "fp8": ("fp8", fp8_body, (a, w), None),
        "fp8_prequantized": ("fp8", fp8_prequantized_body, (a, qf8, sf8),
                             None),
        "bf16_product": ("bf16", torch.mm, (ab, wb),
                         lambda out: out.float()),
        "int8_product": ("int8", int8_product, (qa8, qw8),
                         lambda out: out.float() * sa8 * sw8),
        "fp8_product": ("fp8", fp8_product, (qaf, qf8, saf, sf8),
                        lambda out: out.float()),
    }


def check_accumulators(a: torch.Tensor, w: torch.Tensor) -> dict:
    """`int8_body`'s int32 accumulators against the same int8 operands
    multiplied in float64 (exact: |sum| ≤ 127² · k < 2^53)."""
    qa, _ = quantize_int8(a, 1)
    qw, _ = quantize_int8(w, 0)
    acc = int8_product(qa, column_major(qw)).double()
    plain = qa.double() @ qw.double()
    bad = int((acc != plain).sum())
    return {"acc_equal": bad == 0, "acc_mismatches": bad}


def bound_us(kind: str, flops: float, args, out) -> tuple:
    """(µs, "operations" | "bytes"): the larger of `flops` at the type's
    peak and the arguments read once plus the output written once."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, out))
    t_ops, t_bytes = flops / PEAK_OPS[kind], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e6, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gate_failures(rows) -> list:
    """The rows that fail the probe's gates: the int8 accumulators equal
    to their float64 plain version, each row's error within its type's
    `REL_TOL`, every time a measurement (not clamped)."""
    return [r for r in rows if r.get("acc_equal") is False
            or not r["rel_err"] <= r["rel_tol"] or r["clamped"]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="int8 and FP8 against bf16")
    p.add_argument("--shape", default=",".join(map(str, SHAPE)),
                   help="m,k,n")
    p.add_argument("--iters", type=int, default=64,
                   help="the long chain is 1 + iters products")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import CallChain, chained_time, print_row
    from drn_tpu_torch.evaluate import resolve_device

    dev = resolve_device(args.device)
    m, k, n = (int(x) for x in args.shape.split(","))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    ref = torch.mm(a, w)  # fp32 (TF32 is off in the port)
    flops = 2.0 * m * k * n
    times: Dict[str, float] = {}
    for row, (kind, fn, fargs, full) in rows_of(a, w).items():
        out = fn(*fargs)
        value: Callable = full or (lambda o: o)
        per, t1, clamped = chained_time(
            CallChain(fn, fargs, perturb=keep, consume=consume), args.iters)
        times[row] = per
        base = times["bf16_product" if row.endswith("_product") else "bf16"]
        b_us, b_by = bound_us(kind, flops, fargs, out)
        rec = {"probe": "int8_probe", "row": row, "type": kind, "m": m,
               "k": k, "n": n, "us": per * 1e6, "k1_us": t1 * 1e6,
               "clamped": clamped, "tflops_equiv": flops / per / 1e12,
               "peak_tflops": PEAK_OPS[kind] / 1e12,
               "peak_share": flops / per / PEAK_OPS[kind],
               "bound_us": b_us, "bound_by": b_by,
               "rel_err": rel_err(value(out), ref),
               "rel_tol": REL_TOL[kind],
               "speedup_vs_bf16": base / per, "device": str(dev)}
        if row == "int8":
            rec.update(check_accumulators(a, w))
        print_row(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
