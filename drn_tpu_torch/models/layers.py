"""Shared building blocks (port of drn_tpu/models/layers.py): the kernel
table, the conv block, flax's LayerNorm, linear temporal sampling.

Parameters follow the `TorchDRNParity` state-dict schema (nn.Conv1d weights
(Cout, Cin, K), nn.LayerNorm weight/bias) so a reference-schema `.pth`
loads as it is. The kernels take WIO weights (K, Cin, Cout) in the compute
dtype; without gradients `packed()` builds that form once and reuses it
until the parameters change, so nothing is transposed per call; when a
gradient is wanted it builds it in the graph on every call, so the
gradient reaches the parameters.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.ops.cuda.autograd import (ConvLnReluFn,
                                             FusedFusionBlockFn, FusedStemFn)
from drn_tpu_torch.ops.cuda.conv_block import (LN_EPS,
                                               conv_ln_relu_reference,
                                               layer_norm)
from drn_tpu_torch.ops.cuda.fused_fusion import fused_fusion_block_reference
from drn_tpu_torch.ops.cuda.stem import fused_stem_reference

__all__ = ["Ops", "KERNEL_OPS", "PLAIN_OPS", "ConvBlock", "cdt",
           "layer_norm", "linear_time_sample", "packed", "LN_EPS"]


class Ops(NamedTuple):
    """The three kernel functions a model calls."""

    conv_ln_relu: Callable
    fused_fusion_block: Callable
    fused_stem: Callable


# The kernels' autograd Functions (ops/cuda/autograd.py): kernel on a CUDA
# tensor, plain version on a CPU tensor, forward and recompute backward.
KERNEL_OPS = Ops(ConvLnReluFn.apply, FusedFusionBlockFn.apply,
                 FusedStemFn.apply)
# The plain versions on any device, differentiated by autograd: the model
# that the kernels' model is held against on the card.
PLAIN_OPS = Ops(conv_ln_relu_reference, fused_fusion_block_reference,
                fused_stem_reference)


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def packed(owner: nn.Module, build: Callable[[], tuple], *params,
           dtype: torch.dtype):
    """`build()`'s result, cached on `owner` until one of `params` changes
    (in place: `_version`; by a move: `data_ptr`) or `dtype` does. When
    grad is enabled and a parameter needs it, `build()` runs in the graph
    on every call instead (the cache would cut the gradient off); so it
    does while `torch.export` traces the model, whose tensors have no
    storage to key a cache by, and the packing becomes part of the
    exported graph."""
    if torch.compiler.is_compiling() or (
            torch.is_grad_enabled() and any(p.requires_grad for p in params)):
        return build()
    key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
    cache = owner.__dict__.get("_packed_cache")
    if cache is None or cache[0] != key:
        with torch.no_grad():
            cache = (key, build())
        owner.__dict__["_packed_cache"] = cache
    return cache[1]


def conv_wio(conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, K) → contiguous WIO (K, Cin, Cout) in `dtype`."""
    return conv.weight.permute(2, 1, 0).contiguous().to(dtype)


def kernel_bias(bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bias rounded to the compute dtype (as the JAX package casts it)
    and handed to the kernel in fp32."""
    return bias.to(dtype).float().contiguous()


class ConvBlock(nn.Module):
    """Conv1d (+LayerNorm, +ReLU) on (B, T, C) through `ops.conv_ln_relu`,
    with XLA SAME padding (asymmetric for stride 2)."""

    def __init__(self, cfg: ModelConfig, in_c: int, out_c: int, k: int = 3,
                 stride: int = 1, use_norm: bool = True, use_act: bool = True,
                 ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg, self.stride, self.use_act, self.ops = cfg, stride, use_act, ops
        self.conv = nn.Conv1d(in_c, out_c, k, stride)
        self.norm = nn.LayerNorm(out_c, eps=LN_EPS) if use_norm else None

    def _pack(self):
        dt = cdt(self.cfg)
        out_c = self.conv.out_channels
        if self.norm is not None:
            scale = self.norm.weight.float().contiguous()
            offset = self.norm.bias.float().contiguous()
        else:
            scale = torch.ones(out_c, device=self.conv.weight.device)
            offset = torch.zeros(out_c, device=self.conv.weight.device)
        return (conv_wio(self.conv, dt), kernel_bias(self.conv.bias, dt),
                scale, offset)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ps = [self.conv.weight, self.conv.bias]
        if self.norm is not None:
            ps += [self.norm.weight, self.norm.bias]
        w, b, scale, offset = packed(self, self._pack, *ps, dtype=cdt(self.cfg))
        return self.ops.conv_ln_relu(x.to(cdt(self.cfg)).contiguous(), w, b,
                                     scale, offset, self.stride,
                                     self.norm is not None, self.use_act)


def linear_time_sample(feat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of (B, T, D) features at (B, N) fractional
    indices (clipped to [0, T-1]) → (B, N, D) in fp32. A gather and a
    two-term lerp: exactly the JAX package's result, whose one-hot
    selection matmuls pick the same two rows."""
    t, d = feat.shape[1], feat.shape[-1]
    pos = pos.clamp(0.0, t - 1.0)
    lo = pos.floor()
    hi = (lo + 1.0).clamp(max=t - 1.0)
    w = (pos - lo)[..., None].float()
    take = lambda i: torch.gather(
        feat, 1, i.long()[..., None].expand(-1, -1, d)).float()
    return take(lo) * (1.0 - w) + take(hi) * w
