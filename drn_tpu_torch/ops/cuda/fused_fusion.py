"""Cross-modal fusion in one kernel: the port of
`drn_tpu/ops/pallas/fused_fusion.py::fused_fusion_block` and
`::fused_fusion`.

`fused_fusion_block`: relu(LN(conv1d(v ⊙ q[:, None, :], w, SAME) + b) ·
scale + offset). `fused_fusion`: conv1d(v ⊙ q[:, None, :], w, SAME) + b,
no epilogue, one rounding to v's dtype. The CUDA kernels
(csrc/fused_fusion.cu) form the Hadamard product while they stage a tile
of v, so v ⊙ q never reaches HBM. A CUDA tensor launches a kernel or
raises; a CPU tensor takes the plain version (`*_reference`).

`fused_fusion_backward` is the JAX package's hand-written VJP of
`fused_fusion` (`_bwd`), term for term: its dx is a stride-1 conv without
epilogue and goes through the conv kernel (`conv_ln_relu` with LayerNorm
and ReLU off); dw is K matrix products with fp32 accumulation, which the
JAX package also leaves to its compiler.
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import (check_cout, check_cuda_inputs,
                                               conv_ln_relu,
                                               conv_ln_relu_reference,
                                               conv_vjp, stream_of)
from drn_tpu_torch.utils import flops


def fused_fusion_block_reference(v, q, w, b, scale, offset):
    """Plain version: the product in v's dtype (one rounding, as the
    kernel and the JAX package), then the conv block's plain version."""
    x = v * q[:, None, :].to(v.dtype)
    return conv_ln_relu_reference(x, w, b, scale, offset, 1, True, True)


def fused_fusion_reference(v, q, w, b):
    """Plain version of `fused_fusion`: the product in v's dtype, then the
    conv block's plain version with LayerNorm and ReLU off."""
    x = v * q[:, None, :].to(v.dtype)
    return conv_ln_relu_reference(x, w, b, None, None, 1, False, False)


def _check(name, v, q, w, b, **epilogue):
    bsz, _, d = v.shape
    k, _, dout = w.shape
    if k % 2 == 0:
        raise ValueError(f"{name}: odd kernel width needed, got {k}")
    check_cout(name, dout)
    check_cuda_inputs(
        name,
        v=(v, torch.bfloat16, (None, None, d)),
        q=(q, torch.bfloat16, (bsz, d)),
        w=(w, torch.bfloat16, (k, d, dout)),
        b=(b, torch.float32, (dout,)),
        **{n: (t, torch.float32, (dout,)) for n, t in epilogue.items()},
    )


def fused_fusion_block(v, q, w, b, scale, offset):
    """v: (B, T, D); q: (B, D); w: (K, D, Dout) WIO, K odd;
    b/scale/offset: (Dout,). Output (B, T, Dout) in v.dtype. On CUDA:
    v, q, w bf16; b, scale, offset fp32."""
    if v.device.type == "cpu":
        return fused_fusion_block_reference(v, q, w, b, scale, offset)
    _check("fused_fusion_block", v, q, w, b, scale=scale, offset=offset)
    bsz, t, d = v.shape
    k, _, dout = w.shape
    out = torch.empty((bsz, t, dout), dtype=torch.bfloat16, device=v.device)
    fn = _build.entry("fused_fusion", "drn_fused_fusion_block", 7, 5)
    rc = fn(v.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), out.data_ptr(), bsz, t, d,
            dout, k, stream_of(v))
    if rc != 0:
        raise RuntimeError(f"fused_fusion_block: CUDA error {rc} at launch")
    fused_fusion_block.launches += 1
    flops.add_conv(bsz, t, d, dout, k)
    return out


fused_fusion_block.launches = 0


def fused_fusion(v, q, w, b):
    """conv1d(v ⊙ q[:, None, :], w, SAME) + b. v: (B, T, D); q: (B, D);
    w: (K, D, Dout) WIO, K odd; b: (Dout,). Output (B, T, Dout) in
    v.dtype. On CUDA: v, q, w bf16; b fp32."""
    if v.device.type == "cpu":
        return fused_fusion_reference(v, q, w, b)
    _check("fused_fusion", v, q, w, b)
    bsz, t, d = v.shape
    k, _, dout = w.shape
    out = torch.empty((bsz, t, dout), dtype=torch.bfloat16, device=v.device)
    fn = _build.entry("fused_fusion", "drn_fused_fusion", 5, 5)
    rc = fn(v.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), bsz, t, d, dout, k, stream_of(v))
    if rc != 0:
        raise RuntimeError(f"fused_fusion: CUDA error {rc} at launch")
    fused_fusion.launches += 1
    flops.add_conv(bsz, t, d, dout, k)
    return out


fused_fusion.launches = 0


def fused_fusion_backward(g, v, q, w):
    """The VJP of `fused_fusion` at (v, q, w) for the cotangent g (B, T,
    Dout) in v's dtype: (dv, dq, dw, db) in the dtypes of v, q, w and g,
    as the JAX package's `_bwd` gives them."""
    d = w.shape[1]
    x = v * q[:, None, :]
    # dL/dx: correlate g with the flipped, in/out-transposed kernel.
    w_rev = torch.flip(w, (0,)).transpose(1, 2).contiguous()
    ones = torch.ones(d, dtype=torch.float32, device=g.device)
    zeros = torch.zeros(d, dtype=torch.float32, device=g.device)
    dx = conv_ln_relu(g.contiguous(), w_rev, zeros, ones, zeros, 1, False,
                      False)
    dv = (dx * q[:, None, :]).to(v.dtype)
    dq = (dx * v).float().sum(1).to(q.dtype)
    # dw: the K "bti,bto->io" products of the padded x and g.
    _, dw = conv_vjp(g, x, w, 1, need_dx=False)
    db = g.float().sum((0, 1)).to(g.dtype)
    return dv, dq, dw, db
