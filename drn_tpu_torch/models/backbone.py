"""Video backbone (port of drn_tpu/models/backbone.py): input LayerNorm and
stem conv in one kernel (`fused_stem`), then one ConvBlock per pyramid
level (strides 1, 2, 2, ...)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.layers import (KERNEL_OPS, LN_EPS, ConvBlock, Ops,
                                         cdt, conv_wio, kernel_bias, packed)


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
        x = self.ops.fused_stem(features.float().contiguous(), *p,
                                cdt(self.cfg))
        levels = []
        for blk in self.levels:
            x = blk(x)
            levels.append(x)
        return levels
