"""Cross-modal fusion (port of drn_tpu/models/fusion.py): per level,
relu(LN(conv1d(v ⊙ q, SAME) + b)) through the `fused_fusion_block` kernel,
which keeps the Hadamard product out of HBM."""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.layers import (KERNEL_OPS, LN_EPS, Ops, cdt,
                                         conv_wio, kernel_bias, packed)


class CrossModalFusion(nn.Module):
    """All levels' fusion parameters (schema: fusion_conv.{l},
    fusion_norm.{l}); `forward` fuses each level with its own query."""

    def __init__(self, cfg: ModelConfig, ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg, self.ops = cfg, ops
        d, k = cfg.hidden_dim, cfg.fusion_kernel_size
        self.fusion_conv = nn.ModuleList(
            [nn.Conv1d(d, d, k) for _ in range(cfg.num_levels)])
        self.fusion_norm = nn.ModuleList(
            [nn.LayerNorm(d, eps=LN_EPS) for _ in range(cfg.num_levels)])

    def _pack(self):
        dt = cdt(self.cfg)
        return [(conv_wio(c, dt), kernel_bias(c.bias, dt),
                 n.weight.float().contiguous(), n.bias.float().contiguous())
                for c, n in zip(self.fusion_conv, self.fusion_norm)]

    def forward(self, v_levels: List[torch.Tensor],
                queries: List[torch.Tensor]) -> List[torch.Tensor]:
        """v_levels[l] (B, T_l, D), queries[l] (B, D) → [(B, T_l, D)]."""
        dt = cdt(self.cfg)
        params = [p for m in (*self.fusion_conv, *self.fusion_norm)
                  for p in (m.weight, m.bias)]
        per_level = packed(self, self._pack, *params, dtype=dt)
        return [self.ops.fused_fusion_block(v.to(dt).contiguous(),
                                            q.to(dt).contiguous(), *p)
                for v, q, p in zip(v_levels, queries, per_level)]
