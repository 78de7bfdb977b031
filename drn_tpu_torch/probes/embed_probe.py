"""The word embedding's gradient, by scatter or by a one-hot matmul (port
of scripts/embed_probe.py).

    python -m drn_tpu_torch.probes.embed_probe   # B=384, L=20, V=8000, D=300
    python -m drn_tpu_torch.probes.embed_probe --device cpu \\
        --shape 4,5,64,8 --iters 1                            # a rehearsal

At the flagship's train shapes (B=384 queries of L=20 word ids, a
V=8000 × D=300 fp32 table, ids from seed 0 in [2, V)), the forward and
backward of Σ tanh(table[ids]) with respect to the table, two ways:

  - `take`: `F.embedding`, whose backward is PyTorch's
    `embedding_dense_backward` (a scatter-add of the (B·L, D) gradient
    rows), as the port's query encoder trains its table
    (`models/query_encoder.py`);
  - `matmul-grad`: `MatmulGradEmbedding`, the same forward with the
    backward as the one-hot (B·L, V)ᵀ @ (B·L, D) product, the script's
    `matgrad_embed`. The port keeps TF32 off (`drn_tpu_torch/__init__.py`)
    and this probe leaves it so: the fp32 product (2·B·L·V·D ≈ 36.9
    GFLOP at these shapes) runs on the CUDA cores, not the tensor cores.

Rows (`bench.call_row`, in µs): the host clock's time a forward+backward
of a chain of `--iters` (the table takes the previous run's consumed
scalar), with `clamped`; the device time a call from a profiler trace
(summed and union); the kernels a call; and on `matmul-grad`'s row the
one-hot product's FLOPs and where it runs, and `max_grad_diff`, the
largest difference of the two gradients, against `GRAD_TOL`. One JSON line a row on stdout. Runs on
`cuda` unless `--device cpu`; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

# Both gradients sum each id's few (1 − tanh²) rows in fp32, in another
# order: a few fp32 ulps of values up to the largest count of one id.
GRAD_TOL = 1e-5


class MatmulGradEmbedding(torch.autograd.Function):
    """table[ids], with the table's gradient as onehot(ids)ᵀ @ g."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        gf = g.reshape(-1, g.shape[-1])
        onehot = (flat[:, None] == torch.arange(
            ctx.vocab, device=ids.device)[None, :]).to(g.dtype)
        return onehot.t() @ gf, None


def take_embed(table, ids):
    return F.embedding(ids, table)


def matgrad_embed(table, ids):
    return MatmulGradEmbedding.apply(table, ids)


VARIANTS = {"take": take_embed, "matmul-grad": matgrad_embed}


def value_and_grad(embed, table: torch.Tensor, ids: torch.Tensor):
    """(Σ tanh(embed(table, ids)), its gradient with respect to table)."""
    t = table.detach().requires_grad_(True)
    with torch.enable_grad():
        val = torch.tanh(embed(t, ids)).sum()
        (grad,) = torch.autograd.grad(val, t)
    return val.detach(), grad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the embedding's gradient")
    p.add_argument("--shape", default="384,20,8000,300",
                   help="B,L,V,D")
    p.add_argument("--iters", type=int, default=48,
                   help="chained forward+backward runs per timing")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.bench import call_row, print_row
    from drn_tpu_torch.evaluate import resolve_device

    dev = resolve_device(args.device)
    b, l, v, d = (int(x) for x in args.shape.split(","))
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(dev)
    ids = torch.from_numpy(rng.integers(2, v, (b, l))).to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    grads = {}
    for name, embed in VARIANTS.items():
        run = lambda t, embed=embed: value_and_grad(embed, t, ids)
        grads[name] = run(table)[1]
        rec = {"probe": "embed_probe", "row": name, "B": b, "L": l, "V": v,
               "D": d, "tf32": tf32,
               **call_row(run, (table,), args.iters, dev, unit="us")}
        if name == "matmul-grad":
            rec.update(
                onehot_flops=2 * b * l * v * d,
                onehot_product="fp32 on the " + (
                    "tensor cores (TF32)" if tf32 else "CUDA cores"),
                max_grad_diff=(grads["take"] - grads[name]).abs().max()
                .item(), grad_tol=GRAD_TOL)
        print_row(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
