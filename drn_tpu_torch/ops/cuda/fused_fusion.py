"""Cross-modal fusion in one kernel: the port of
`drn_tpu/ops/pallas/fused_fusion.py::fused_fusion_block` and
`::fused_fusion`.

`fused_fusion_block`: relu(LN(conv1d(v ⊙ q[:, None, :], w, SAME) + b) ·
scale + offset). `fused_fusion`: conv1d(v ⊙ q[:, None, :], w, SAME) + b,
no epilogue, one rounding to v's dtype. The CUDA kernels
(csrc/fused_fusion.cu) are the Hadamard variant of the conv block's kernel
(csrc/conv_sm90.cuh): its producer forms v ⊙ q[b] in registers while it
stages a tile of A, so the product never reaches HBM. The launch geometry
is the conv block's, `conv_plan(B·T, Dout, SMs)`. A CUDA tensor launches a
kernel or raises; a CPU tensor takes the plain version (`*_reference`).

`fused_fusion_block_bwd` (custom op
`torch.ops.drn_tpu_torch.fused_fusion_block_bwd`) is the block's backward
epilogue on the same Hadamard kernel, as `conv_block.conv_ln_relu_bwd` is
the conv block's: the conv recomputed, the LayerNorm+ReLU VJP taken at the
fp32 accumulator, (dpre, dscale, doffset, db).

`fused_fusion_backward` is the JAX package's hand-written VJP of
`fused_fusion` (`_bwd`), term for term: its dx is a stride-1 conv without
epilogue and goes through the conv kernel (`conv_ln_relu` with LayerNorm
and ReLU off); dw is K matrix products with fp32 accumulation, which the
JAX package also leaves to its compiler.
"""

from __future__ import annotations

from typing import Tuple

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import (bwd_outputs, check_cout,
                                               check_cuda_inputs,
                                               conv_ln_relu,
                                               conv_ln_relu_bwd_reference,
                                               conv_ln_relu_reference,
                                               conv_plan, conv_vjp,
                                               refuse_grad, stream_of)
from drn_tpu_torch.utils import flops

# csrc/conv_sm90.cuh (kMaxK): a producer thread of the Hadamard variant
# holds a chunk's (rows + K - 1)-row window.
MAX_K = 17


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


def fused_fusion_block_bwd_reference(v, q, w, b, scale, offset, g):
    """Plain version of the block's backward kernel: the product in v's
    dtype, then the conv block's (dpre in v.dtype, dscale, doffset, db)."""
    x = v * q[:, None, :].to(v.dtype)
    return conv_ln_relu_bwd_reference(x, w, b, scale, offset, g, 1, True)


def _check(name, v, q, w, b, **more):
    """Raise unless the kernel takes these inputs: odd K up to MAX_K, a
    built Dout, bf16 v/q/w, fp32 b and every `more` of its shape."""
    bsz, t, d = v.shape
    k, _, dout = w.shape
    if k % 2 == 0 or k > MAX_K:
        raise ValueError(f"{name}: K={k}; the kernel takes odd K up to "
                         f"{MAX_K}")
    check_cout(name, dout)
    check_cuda_inputs(
        name,
        v=(v, torch.bfloat16, (None, None, d)),
        q=(q, torch.bfloat16, (bsz, d)),
        w=(w, torch.bfloat16, (k, d, dout)),
        b=(b, torch.float32, (dout,)),
        **more,
    )


def _launch(name, v, q, w, b, **epilogue):
    """Check the inputs, launch `drn_<name>` on conv_plan's split and grid,
    count its FLOPs; the (B, T, Dout) bf16 output. The body of both custom
    ops, run when the op runs."""
    bsz, t, d = v.shape
    k, _, dout = w.shape
    _check(name, v, q, w, b, **{n: (t_, torch.float32, (dout,))
                                for n, t_ in epilogue.items()})
    plan = conv_plan(bsz * t, dout, torch.cuda.get_device_properties(
        v.device).multi_processor_count)
    out = torch.empty((bsz, t, dout), dtype=torch.bfloat16, device=v.device)
    ptrs = [x.data_ptr() for x in (v, q, w, b, *epilogue.values(), out)]
    fn = _build.entry("fused_fusion", "drn_" + name, len(ptrs), 7)
    rc = fn(*ptrs, bsz, t, d, dout, k, *plan, stream_of(v))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    flops.add_conv(bsz, t, d, dout, k)
    return out


def _fake(v, w):
    return v.new_empty((*v.shape[:2], w.shape[2]), dtype=torch.bfloat16)


def fused_fusion_block(v, q, w, b, scale, offset):
    """v: (B, T, D); q: (B, D); w: (K, D, Dout) WIO, K odd;
    b/scale/offset: (Dout,). Output (B, T, Dout) in v.dtype. On CUDA:
    v, q, w bf16; b, scale, offset fp32; K up to MAX_K; the launch is the
    custom op `torch.ops.drn_tpu_torch.fused_fusion_block`."""
    if v.device.type == "cpu":
        return fused_fusion_block_reference(v, q, w, b, scale, offset)
    refuse_grad("fused_fusion_block", v=v, q=q, w=w, b=b, scale=scale,
                offset=offset)
    return fused_fusion_block_op(v, q, w, b, scale, offset)


fused_fusion_block.launches = 0


@torch.library.custom_op("drn_tpu_torch::fused_fusion_block",
                         mutates_args=(), device_types="cuda")
def fused_fusion_block_op(v: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, scale: torch.Tensor,
                          offset: torch.Tensor) -> torch.Tensor:
    out = _launch("fused_fusion_block", v, q, w, b, scale=scale,
                  offset=offset)
    fused_fusion_block.launches += 1
    return out


@fused_fusion_block_op.register_fake
def _(v, q, w, b, scale, offset):
    return _fake(v, w)


def fused_fusion_block_bwd(v, q, w, b, scale, offset, g):
    """The backward of fused_fusion_block for its output's cotangent g
    (B, T, Dout): (dpre (B, T, Dout) in v.dtype, the VJP at the recomputed
    fp32 conv + b; dscale, doffset, db (Dout,) fp32). On CUDA: the inputs
    as `fused_fusion_block` takes them, g bf16; the launch is the custom op
    `torch.ops.drn_tpu_torch.fused_fusion_block_bwd`."""
    if v.device.type == "cpu":
        return fused_fusion_block_bwd_reference(v, q, w, b, scale, offset, g)
    refuse_grad("fused_fusion_block_bwd", v=v, q=q, w=w, b=b, scale=scale,
                offset=offset, g=g)
    return fused_fusion_block_bwd_op(v, q, w, b, scale, offset, g)


fused_fusion_block_bwd.launches = 0


@torch.library.custom_op("drn_tpu_torch::fused_fusion_block_bwd",
                         mutates_args=(), device_types="cuda")
def fused_fusion_block_bwd_op(v: torch.Tensor, q: torch.Tensor,
                              w: torch.Tensor, b: torch.Tensor,
                              scale: torch.Tensor, offset: torch.Tensor,
                              g: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """The backward kernel's launch (one block a row tile) and the tiles'
    column sums, its count and its FLOPs (the recompute's conv)."""
    bsz, t, d = v.shape
    k, _, dout = w.shape
    name = "fused_fusion_block_bwd"
    _check(name, v, q, w, b, scale=(scale, torch.float32, (dout,)),
           offset=(offset, torch.float32, (dout,)),
           g=(g, torch.bfloat16, (bsz, t, dout)))
    dpre, part, ds, do, db = bwd_outputs(g)
    ptrs = [a.data_ptr() for a in (v, q, w, b, scale, offset, g, dpre, part,
                                   ds, do, db)]
    fn = _build.entry("fused_fusion", "drn_" + name, len(ptrs), 6)
    rc = fn(*ptrs, bsz, t, d, dout, k, part.shape[0], stream_of(v))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    fused_fusion_block_bwd.launches += 1
    flops.add_conv(bsz, t, d, dout, k)
    return dpre, ds, do, db


@fused_fusion_block_bwd_op.register_fake
def _(v, q, w, b, scale, offset, g):
    return (torch.empty_like(g, dtype=torch.bfloat16),
            *(g.new_empty(w.shape[2], dtype=torch.float32) for _ in range(3)))


def fused_fusion(v, q, w, b):
    """conv1d(v ⊙ q[:, None, :], w, SAME) + b. v: (B, T, D); q: (B, D);
    w: (K, D, Dout) WIO, K odd; b: (Dout,). Output (B, T, Dout) in
    v.dtype. On CUDA: v, q, w bf16; b fp32; K up to MAX_K; the launch is
    the custom op `torch.ops.drn_tpu_torch.fused_fusion`."""
    if v.device.type == "cpu":
        return fused_fusion_reference(v, q, w, b)
    refuse_grad("fused_fusion", v=v, q=q, w=w, b=b)
    return fused_fusion_op(v, q, w, b)


fused_fusion.launches = 0


@torch.library.custom_op("drn_tpu_torch::fused_fusion", mutates_args=(),
                         device_types="cuda")
def fused_fusion_op(v: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    out = _launch("fused_fusion", v, q, w, b)
    fused_fusion.launches += 1
    return out


@fused_fusion_op.register_fake
def _(v, q, w, b):
    return _fake(v, w)


def fused_fusion_backward(g, v, q, w, need_db: bool = True):
    """The VJP of `fused_fusion` at (v, q, w) for the cotangent g (B, T,
    Dout) in v's dtype: (dv, dq, dw, db) in the dtypes of v, q, w and g,
    as the JAX package's `_bwd` gives them (db None unless `need_db`)."""
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
    db = g.float().sum((0, 1)).to(g.dtype) if need_db else None
    return dv, dq, dw, db
