"""Temporal FPN (port of drn_tpu/models/fpn.py): k=1 laterals (LN, no
ReLU), nearest 2x upsampling top-down, k=3 smoothing blocks."""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.layers import KERNEL_OPS, ConvBlock, Ops, cdt


class TemporalFPN(nn.Module):
    def __init__(self, cfg: ModelConfig, ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg = cfg
        d, n = cfg.hidden_dim, cfg.num_levels
        self.lateral = nn.ModuleList(
            [ConvBlock(cfg, d, d, 1, use_act=False, ops=ops) for _ in range(n)])
        self.smooth = nn.ModuleList(
            [ConvBlock(cfg, d, d, 3, ops=ops) for _ in range(n)])

    def forward(self, levels: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(levels)
        laterals = [self.lateral[l](levels[l]) for l in range(n)]
        outs = [None] * n
        outs[-1] = laterals[-1]
        for l in range(n - 2, -1, -1):
            outs[l] = laterals[l] + outs[l + 1].repeat_interleave(2, dim=1)
        return [self.smooth[l](outs[l].to(cdt(self.cfg))) for l in range(n)]
