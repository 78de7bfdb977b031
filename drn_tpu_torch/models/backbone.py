"""Video backbone (port of drn_tpu/models/backbone.py): input LayerNorm and
stem conv in one kernel (`fused_stem`), then one ConvBlock per pyramid
level (strides 1, 2, 2, ...).

Under a time axis the features come with STEM_HALO rows each side where
the clip axis goes on (parallel/mesh.py::time_slice, sliced on the host):
the stem runs SAME on them and keeps its block's rows. (Zero rows would
be wrong there: the input LayerNorm maps a zero row to its offset.)
Under a model axis the stem runs on this rank's output channels with its
output epilogue off, the input LayerNorm in its prologue (F is not
split), then layers.split_epilogue."""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.layers import (KERNEL_OPS, LN_EPS, WHOLE, ConvBlock,
                                         Ops, cdt, conv_wio, kernel_bias,
                                         packed, split_epilogue)
from drn_tpu_torch.parallel.collectives import (axis_rank, axis_size,
                                                split_channels, sum_grad)
from drn_tpu_torch.parallel.mesh import STEM_HALO


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg, self.ops = cfg, ops
        d = cfg.hidden_dim
        self.input_norm = nn.LayerNorm(cfg.feature_dim, eps=LN_EPS)
        # The stem's parameters in the ConvBlock schema; its forward is the
        # fused kernel below, never ConvBlock.forward.
        self.stem = ConvBlock(cfg, cfg.feature_dim, d, 3, ops=ops)
        self.levels = nn.ModuleList(
            [ConvBlock(cfg, d, d, 3, stride=1 if l == 0 else 2, ops=ops)
             for l in range(cfg.num_levels)])

    def _pack_stem(self):
        dt, s = cdt(self.cfg), self.stem
        f32 = lambda p: p.float().contiguous()
        return (f32(self.input_norm.weight), f32(self.input_norm.bias),
                conv_wio(s.conv, dt), kernel_bias(s.conv.bias, dt),
                f32(s.norm.weight), f32(s.norm.bias))

    def forward(self, features: torch.Tensor) -> List[torch.Tensor]:
        """features (B, T, F) → [(B, T / 2**l, D) for each level]."""
        s = self.stem
        p = packed(self, self._pack_stem, self.input_norm.weight,
                   self.input_norm.bias, s.conv.weight, s.conv.bias,
                   s.norm.weight, s.norm.bias, dtype=cdt(self.cfg))
        x = features.float().contiguous()
        if s.axes == WHOLE:
            x = self.ops.fused_stem(x, *p, cdt(self.cfg))
        else:
            x = self._split_stem(x, p)
        levels = []
        for blk in self.levels:
            x = blk(x)
            levels.append(x)
        return levels

    def _split_stem(self, x, p):
        model, time = self.stem.axes
        in_s, in_b, w, b, out_s, out_b = p
        lo, hi = 0, None
        if time is not None:  # STEM_HALO rows each side but at the ends
            r = axis_rank(time)
            lo = STEM_HALO if r > 0 else 0
            hi = x.shape[1] - (STEM_HALO if r + 1 < axis_size(time) else 0)
        if model is None:
            return self.ops.fused_stem(x, *p, cdt(self.cfg))[:, lo:hi]
        ones = torch.ones(w.shape[2], device=w.device)
        y = self.ops.fused_stem(
            x, sum_grad(in_s, model), sum_grad(in_b, model), w,
            split_channels(b, model), ones, torch.zeros_like(ones),
            cdt(self.cfg), False, False)
        return split_epilogue(y[:, lo:hi], out_s, out_b,
                              self.stem.conv.out_channels, True, model)

