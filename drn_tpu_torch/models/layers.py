"""Shared building blocks (port of drn_tpu/models/layers.py): the kernel
table, the conv block, flax's LayerNorm, linear temporal sampling.

Parameters follow the `TorchDRNParity` state-dict schema (nn.Conv1d weights
(Cout, Cin, K), nn.LayerNorm weight/bias) so a reference-schema `.pth`
loads as it is. The kernels take WIO weights (K, Cin, Cout) in the compute
dtype; without gradients `packed()` builds that form once and reuses it
until the parameters change, so nothing is transposed per call; when a
gradient is wanted it builds it in the graph on every call, so the
gradient reaches the parameters.

Under a mesh with a model or time axis (parallel/mesh.py) a layer holds
its `Axes`: the model group when its output channels are split over the
model ranks, the time group when it runs on this rank's block of the clip
axis. `ConvBlock.forward` then does its part with the same kernels and
the collectives of parallel/collectives.py (see `ConvBlock`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.ops.cuda.autograd import (ConvLnReluFn,
                                             FusedFusionBlockFn,
                                             FusedFusionFn, FusedStemFn)
from drn_tpu_torch.ops.cuda.conv_block import (LN_EPS,
                                               conv_ln_relu_reference,
                                               layer_norm)
from drn_tpu_torch.ops.cuda.fused_fusion import (fused_fusion_block_reference,
                                                 fused_fusion_reference)
from drn_tpu_torch.ops.cuda.stem import fused_stem_reference
from drn_tpu_torch.parallel.collectives import (gather_channels, halo,
                                                split_channels, sum_grad,
                                                sum_over)

__all__ = ["Axes", "Ops", "KERNEL_OPS", "PLAIN_OPS", "ConvBlock", "cdt",
           "layer_norm", "linear_time_sample", "packed", "split_epilogue",
           "time_window", "LN_EPS"]


class Ops(NamedTuple):
    """The kernel functions a model calls (`fused_fusion`, B4, only under
    a model axis)."""

    conv_ln_relu: Callable
    fused_fusion_block: Callable
    fused_stem: Callable
    fused_fusion: Optional[Callable] = None


# The kernels' autograd Functions (ops/cuda/autograd.py): kernel on a CUDA
# tensor, plain version on a CPU tensor, forward and recompute backward.
KERNEL_OPS = Ops(ConvLnReluFn.apply, FusedFusionBlockFn.apply,
                 FusedStemFn.apply, FusedFusionFn.apply)
# The plain versions on any device, differentiated by autograd: the model
# that the kernels' model is held against on the card.
PLAIN_OPS = Ops(conv_ln_relu_reference, fused_fusion_block_reference,
                fused_stem_reference, fused_fusion_reference)


class Axes(NamedTuple):
    """A layer's place on the mesh: `model`, the model group when its
    output channels are split; `time`, the time group when it runs on a
    block of the clip axis (None: whole)."""

    model: Any = None
    time: Any = None


WHOLE = Axes()


def time_window(k: int, stride: int, length: int):
    """A SAME conv of width `k` on a time block of `length` rows: (left,
    right) halo rows, then the rows [lo, hi) of the kernel's SAME output
    on the extended block that are this block's. Stride 1: k // 2 rows
    each side. Stride 2 (k = 3, even T): XLA's SAME pads 0 left and 1
    right, so output o reads rows 2o..2o+2; two right rows make the
    extension's length even, where the kernel's own SAME padding is again
    0 left, and its first length / 2 outputs are this block's."""
    if k == 1:
        return 0, 0, 0, length // stride
    if stride == 1 and k % 2:
        return k // 2, k // 2, k // 2, k // 2 + length
    if stride == 2 and k == 3 and length % 2 == 0:
        return 0, 2, 0, length // 2
    raise ValueError(f"no time-split form for k={k}, stride={stride}, "
                     f"{length} rows")


def row_sums(y: torch.Tensor) -> torch.Tensor:
    """(..., C) → (..., 2): each row's Σy and Σy² in fp32."""
    y = y.float()
    return torch.stack([y.sum(-1), (y * y).sum(-1)], -1)


def block_layer_norm(y: torch.Tensor, sums: torch.Tensor,
                     scale: torch.Tensor, offset: torch.Tensor,
                     width: int) -> torch.Tensor:
    """flax's LayerNorm (fast variance, eps 1e-6) of a channel block `y`
    of `width`-wide rows whose `row_sums` over every block are `sums`;
    `scale` / `offset` are the block's. fp32."""
    mean, msq = (sums / width).split(1, -1)
    var = (msq - mean * mean).clamp_min(0.0)
    return (y.float() - mean) * (torch.rsqrt(var + LN_EPS) * scale.float()) \
        + offset.float()


def split_epilogue(y: torch.Tensor, scale: Optional[torch.Tensor],
                   offset: Optional[torch.Tensor], width: int,
                   use_act: bool, group) -> torch.Tensor:
    """The fused kernels' epilogue on a channel block `y` of a `width`-wide
    layer: the LayerNorm from the rows' sums added up over `group`
    (`scale` None: none), the ReLU, then the blocks gathered → (...,
    width) in y's dtype (the kernels' output type). `scale` / `offset`
    are whole."""
    dtype = y.dtype
    y = y.float()
    if scale is not None:
        y = block_layer_norm(y, sum_over(row_sums(y), group),
                             split_channels(scale, group),
                             split_channels(offset, group), width)
    if use_act:
        y = torch.relu(y)
    return gather_channels(y.to(dtype), group)


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
        self.axes = WHOLE

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
        x = x.to(cdt(self.cfg))
        if self.axes == WHOLE:
            return self.ops.conv_ln_relu(x.contiguous(), w, b, scale, offset,
                                         self.stride, self.norm is not None,
                                         self.use_act)
        return self._split(x, w, b, scale, offset)

    def _split(self, x, w, b, scale, offset):
        """The block's part under its `axes`. Time: the block with its
        halo rows (`time_window`), the kernel SAME on it, this block's
        rows kept. Model: the kernel on this rank's output channels with
        its epilogue off, then `split_epilogue`; the input's gradient is
        the sum of every channel block's (`sum_grad`)."""
        model, time = self.axes
        k = self.conv.kernel_size[0]
        left, right, lo, hi = 0, 0, 0, None
        if time is not None:
            left, right, lo, hi = time_window(k, self.stride, x.shape[1])
            x = halo(x, left, right, time)
        if model is None:
            y = self.ops.conv_ln_relu(x.contiguous(), w, b, scale, offset,
                                      self.stride, self.norm is not None,
                                      self.use_act)
            return y[:, lo:hi]
        ones = torch.ones(w.shape[2], device=w.device)
        y = self.ops.conv_ln_relu(
            sum_grad(x, model).contiguous(), w, split_channels(b, model),
            ones, torch.zeros_like(ones), self.stride, False, False)
        norm = self.norm is not None
        return split_epilogue(y[:, lo:hi], scale if norm else None,
                              offset if norm else None,
                              self.conv.out_channels, self.use_act, model)


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
