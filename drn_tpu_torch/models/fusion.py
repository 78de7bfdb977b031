"""Cross-modal fusion (port of drn_tpu/models/fusion.py): per level,
relu(LN(conv1d(v ⊙ q, SAME) + b)) through the `fused_fusion_block` kernel,
which keeps the Hadamard product out of HBM.

Under a time axis each level's block takes k // 2 halo rows each side
(zeros at the clip axis's ends, which v ⊙ q keeps zero: SAME padding's),
and q, whole on every time rank, sums its gradient over them. Under a
model axis the `fused_fusion` kernel (B4: v ⊙ q, conv + bias, no
epilogue) runs on this rank's output channels, then
layers.split_epilogue."""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.layers import (KERNEL_OPS, LN_EPS, WHOLE, Axes, Ops,
                                         cdt, conv_wio, kernel_bias, packed,
                                         split_epilogue, time_window)
from drn_tpu_torch.parallel.collectives import halo, split_channels, sum_grad


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
        self.axes = [WHOLE] * cfg.num_levels

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
                if ax == WHOLE else self._split(v.to(dt), q.to(dt), p, ax)
                for v, q, p, ax in zip(v_levels, queries, per_level,
                                       self.axes)]

    def _split(self, v, q, p, axes: Axes):
        model, time = axes
        w, b, scale, offset = p
        lo, hi = 0, None
        if time is not None:
            left, right, lo, hi = time_window(w.shape[0], 1, v.shape[1])
            v, q = halo(v, left, right, time), sum_grad(q, time)
        if model is None:
            return self.ops.fused_fusion_block(v.contiguous(), q.contiguous(),
                                               *p)[:, lo:hi]
        y = self.ops.fused_fusion(sum_grad(v, model).contiguous(),
                                  sum_grad(q, model).contiguous(), w,
                                  split_channels(b, model))
        return split_epilogue(y[:, lo:hi], scale, offset,
                              self.cfg.hidden_dim, True, model)
