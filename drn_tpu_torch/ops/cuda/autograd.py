"""Gradients of the four kernels: `torch.autograd.Function`s with the
recompute backward of the JAX package's custom VJPs.

Each forward launches its kernel (through the wrapper: the plain version on
a CPU tensor) and saves its inputs only; nothing of (B, T, C) size is kept
between forward and backward, the contract of the JAX custom VJPs. Each
backward recomputes the pre-LayerNorm conv with a kernel and takes the
fp32 LayerNorm+ReLU VJP, casts the cotangent to the compute dtype (the
transpose of the forward's cast to fp32), then takes the conv's VJP. Where
LayerNorm is on, the conv block and the fusion block do the first two in
one launch, their kernel's backward epilogue (`conv_ln_relu_bwd`,
`fused_fusion_block_bwd`: the VJP in closed form at the fp32 accumulator,
and dscale, doffset, db); the stem recomputes with its kernel and takes
the VJP in PyTorch (`epilogue_vjp`), as the conv block does without
LayerNorm:

  ConvLnReluFn      drn_tpu/ops/pallas/conv_block.py  `_bwd`: the conv VJP
                    as matrix products (the JAX package leaves it to XLA);
                    stride 2 scatters each tap's rows back with stride 2.
  FusedStemFn       drn_tpu/ops/pallas/stem.py `_bwd`: as ConvLnReluFn on the
                    normalised input, then the input LayerNorm's VJP.
  FusedFusionBlockFn  drn_tpu/ops/pallas/fused_fusion.py `_block_bwd`: the
                    pre-epilogue conv is exactly `fused_fusion`, whose VJP
                    is `fused_fusion_backward` (the JAX package's `_bwd`).
  FusedFusionFn     drn_tpu/ops/pallas/fused_fusion.py `_bwd`.

The backward code is the same on every device: on a CPU tensor the
wrappers run the plain versions, so the CPU tests hold this code itself
against JAX. `KERNEL_OPS` in models/layers.py calls these Functions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from drn_tpu_torch.ops.cuda.conv_block import (conv_ln_relu,
                                               conv_ln_relu_bwd, conv_vjp,
                                               layer_norm)
from drn_tpu_torch.ops.cuda.fused_fusion import (fused_fusion,
                                                 fused_fusion_backward,
                                                 fused_fusion_block,
                                                 fused_fusion_block_bwd)
from drn_tpu_torch.ops.cuda.stem import fused_stem


def _identity_epilogue(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.ones(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device))


def epilogue_vjp(pre: torch.Tensor, scale: torch.Tensor,
                 offset: torch.Tensor, g: torch.Tensor, use_norm: bool,
                 use_act: bool):
    """VJP of y = relu?(LN?(pre)) at the recomputed pre-epilogue conv `pre`
    (compute dtype): (dpre in pre's dtype, dscale, doffset). LayerNorm and
    its ReLU run in fp32 as in the forward; without LayerNorm the ReLU acts
    on `pre` itself."""
    if not use_norm:
        dpre = g * (pre > 0).to(g.dtype) if use_act else g
        return dpre.to(pre.dtype), None, None
    with torch.enable_grad():
        z = pre.detach().float().requires_grad_()
        s = scale.detach().requires_grad_()
        o = offset.detach().requires_grad_()
        y = layer_norm(z, s, o)
        if use_act:
            y = torch.relu(y)
        dz, ds, do = torch.autograd.grad(y, (z, s, o), g.float())
    return dz.to(pre.dtype), ds, do


class ConvLnReluFn(torch.autograd.Function):
    """conv_ln_relu(x, w, b, scale, offset, stride, use_norm, use_act)."""

    @staticmethod
    def forward(ctx, x, w, b, scale, offset, stride, use_norm, use_act):
        ctx.save_for_backward(x, w, b, scale, offset)
        ctx.conf = (stride, use_norm, use_act)
        return conv_ln_relu(x, w, b, scale, offset, stride, use_norm, use_act)

    @staticmethod
    def backward(ctx, g):
        x, w, b, scale, offset = ctx.saved_tensors
        stride, use_norm, use_act = ctx.conf
        need = ctx.needs_input_grad
        if use_norm:
            dpre, ds, do, db = conv_ln_relu_bwd(x, w, b, scale, offset,
                                                g.contiguous(), stride,
                                                use_act)
        else:
            ones, zeros = _identity_epilogue(w.shape[2], x.device)
            pre = conv_ln_relu(x, w, b, ones, zeros, stride, False, False)
            dpre, ds, do = epilogue_vjp(pre, scale, offset, g, False, use_act)
            db = dpre.float().sum((0, 1))
        dx, dw = conv_vjp(dpre, x, w, stride, need[0], need[1])
        db = db.to(b.dtype) if need[2] else None
        return dx, dw, db, ds, do, None, None, None


class FusedStemFn(torch.autograd.Function):
    """fused_stem(x, in_scale, in_bias, w, b, out_scale, out_bias, cdtype,
    use_norm, use_act)."""

    @staticmethod
    def forward(ctx, x, in_scale, in_bias, w, b, out_scale, out_bias,
                cdtype=torch.bfloat16, use_norm=True, use_act=True):
        ctx.save_for_backward(x, in_scale, in_bias, w, b, out_scale, out_bias)
        ctx.conf = (cdtype, use_norm, use_act)
        return fused_stem(x, in_scale, in_bias, w, b, out_scale, out_bias,
                          cdtype, use_norm, use_act)

    @staticmethod
    def backward(ctx, g):
        x, in_scale, in_bias, w, b, out_scale, out_bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        ones, zeros = _identity_epilogue(w.shape[2], x.device)
        cdtype, use_norm, use_act = ctx.conf
        pre = fused_stem(x, in_scale, in_bias, w, b, ones, zeros, cdtype,
                         False, False)
        dpre, ds, do = epilogue_vjp(pre, out_scale, out_bias, g, use_norm,
                                    use_act)
        db = dpre.float().sum((0, 1)).to(b.dtype) if need[4] else None
        need_in = any(need[:3])
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip((x, in_scale, in_bias), need[:3])]
            xn = layer_norm(*ins)
        dxn, dw = conv_vjp(dpre, xn.detach().to(cdtype), w, 1, need_in,
                           need[3])
        grads = [None] * 3
        if need_in:
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(xn, wanted, dxn.float()))
            grads = [next(got) if t.requires_grad else None for t in ins]
        return (*grads, dw, db, ds, do, None, None, None)


class FusedFusionBlockFn(torch.autograd.Function):
    """fused_fusion_block(v, q, w, b, scale, offset)."""

    @staticmethod
    def forward(ctx, v, q, w, b, scale, offset):
        ctx.save_for_backward(v, q, w, b, scale, offset)
        return fused_fusion_block(v, q, w, b, scale, offset)

    @staticmethod
    def backward(ctx, g):
        v, q, w, b, scale, offset = ctx.saved_tensors
        dpre, ds, do, db = fused_fusion_block_bwd(v, q, w, b, scale, offset,
                                                  g.contiguous())
        dv, dq, dw, _ = fused_fusion_backward(dpre, v, q, w, need_db=False)
        return dv, dq, dw, db.to(b.dtype), ds, do


class FusedFusionFn(torch.autograd.Function):
    """fused_fusion(v, q, w, b)."""

    @staticmethod
    def forward(ctx, v, q, w, b):
        ctx.save_for_backward(v, q, w)
        ctx.b_dtype = b.dtype
        return fused_fusion(v, q, w, b)

    @staticmethod
    def backward(ctx, g):
        v, q, w = ctx.saved_tensors
        dv, dq, dw, db = fused_fusion_backward(g.to(v.dtype), v, q, w)
        return dv, dq, dw, db.to(ctx.b_dtype)
