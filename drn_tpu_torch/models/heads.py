"""Dense anchor-free heads (port of drn_tpu/models/heads.py): boundary
regression and matching towers shared across levels, and the IoU head.

The towers run once over all levels concatenated along time with one zero
gap column between consecutive levels (T = 64+1+32+1+16 = 114 at the
flagship), re-zeroed after every block, so each k=3 conv reads exactly the
zeros a per-level SAME conv would pad. Distances are soft-capped:
exp(8·tanh(scale_l·raw/8))·stride.

The IoU head samples each level's pyramid features at the regressed
segment's start / mid / end (positions clipped inside the location's own
level) with a per-level gather, for every grid size; the JAX package's
flat and blocked sampling give the same values.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.layers import (KERNEL_OPS, ConvBlock, Ops, cdt,
                                         linear_time_sample)


def gap_layout(sizes: Sequence[int]) -> np.ndarray:
    """Indices of the real (non-gap) columns of the gap-padded concat."""
    idx, off = [], 0
    for i, t in enumerate(sizes):
        idx.append(np.arange(off, off + t))
        off += t + (1 if i + 1 < len(sizes) else 0)
    return np.concatenate(idx)


def gap_concat(levels: List[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T_l, D) levels → (B, ΣT_l + L-1, D) with zero gap columns, and
    its (1, total, 1) validity mask in the levels' dtype."""
    b, _, d = levels[0].shape
    parts, mask = [], []
    for i, lvl in enumerate(levels):
        parts.append(lvl)
        mask.append(torch.ones(lvl.shape[1]))
        if i + 1 < len(levels):
            parts.append(lvl.new_zeros((b, 1, d)))
            mask.append(torch.zeros(1))
    m = torch.cat(mask).to(levels[0].device, levels[0].dtype)[None, :, None]
    return torch.cat(parts, dim=1), m


def same_conv(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype):
    """A plain stride-1, odd-width SAME conv on (B, T, C) in `dtype` (the
    heads' output convs, which the JAX package also leaves to the
    framework's conv)."""
    k = conv.kernel_size[0]
    xt = F.pad(x.to(dtype).transpose(1, 2), (k // 2, k // 2))
    return F.conv1d(xt, conv.weight.to(dtype), conv.bias.to(dtype)
                    ).transpose(1, 2)


class GroundingHeads(nn.Module):
    """Location + matching heads; flat (B, N) outputs, level-major."""

    def __init__(self, cfg: ModelConfig, ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        tower = lambda: nn.ModuleList(
            [ConvBlock(cfg, d, d, 3, ops=ops)
             for _ in range(cfg.head_tower_layers)])
        self.loc_tower, self.match_tower = tower(), tower()
        self.loc_out = nn.Conv1d(d, 2, 3)
        self.match_out = nn.Conv1d(d, 1, 3)
        self.scales = nn.Parameter(torch.ones(cfg.num_levels))

    def _tower(self, blocks, out, x, mask):
        for blk in blocks:
            x = blk(x) * mask
        return same_conv(x, out, cdt(self.cfg)).float()

    def forward(self, pyramid: List[torch.Tensor]):
        sizes = [p.shape[1] for p in pyramid]
        valid = torch.as_tensor(gap_layout(sizes), device=pyramid[0].device)
        x, mask = gap_concat(pyramid)
        raw_loc = self._tower(self.loc_tower, self.loc_out, x, mask)[:, valid]
        match = self._tower(self.match_tower, self.match_out, x, mask)
        match_logits = match[:, valid, 0]
        dev = raw_loc.device
        scale = torch.cat([self.scales[l].expand(t)
                           for l, t in enumerate(sizes)])
        stride = torch.cat([torch.full((t,), float(2 ** l), device=dev)
                            for l, t in enumerate(sizes)])
        c = 8.0
        z = scale[None, :, None] * raw_loc
        d = torch.exp(c * torch.tanh(z / c)) * stride[None, :, None]
        return d[..., 0], d[..., 1], match_logits


def segment_positions(sizes: Sequence[int], segments: torch.Tensor,
                      level_ids: torch.Tensor, strides: torch.Tensor
                      ) -> List[torch.Tensor]:
    """The flat fractional indices (B, N) of each location's segment
    start, mid and end (segments (B, N, 2) in base-grid units; level_ids,
    strides (N,)), each clipped inside the location's own level."""
    starts = np.cumsum([0] + list(sizes[:-1]))
    dev = segments.device
    lo = torch.as_tensor(starts, dtype=torch.float32, device=dev)[level_ids]
    hi = lo + torch.as_tensor(sizes, dtype=torch.float32,
                              device=dev)[level_ids] - 1.0
    start, end = segments[..., 0], segments[..., 1]
    mid = 0.5 * (start + end)
    return [torch.minimum(torch.maximum(p / strides - 0.5 + lo, lo), hi)
            for p in (start, mid, end)]


def level_positions(sizes: Sequence[int], pos: List[torch.Tensor]
                    ) -> List[List[torch.Tensor]]:
    """Per level, its (B, T_l) blocks of the flat positions `pos` (start,
    mid, end) less the level's offset: positions inside the level. `- off`
    is exact in fp32 (the JAX package's blocked sampling relies on the
    same fact), so these pick what the flat positions pick."""
    out, off = [], 0
    for t_l in sizes:
        out.append([q[:, off:off + t_l] - float(off) for q in pos])
        off += t_l
    return out


def segment_samples(pyramid: List[torch.Tensor], pos: List[torch.Tensor]
                    ) -> torch.Tensor:
    """Each level's features gathered at its locations' start, mid and end
    positions (`segment_positions`) → (B, N, 3D) fp32."""
    per_level = level_positions([p.shape[1] for p in pyramid], pos)
    return torch.cat([torch.cat([linear_time_sample(p_l, q) for q in qs],
                                dim=-1)                      # (B, T_l, 3D)
                      for p_l, qs in zip(pyramid, per_level)], dim=1)


class IoUHead(nn.Module):
    """Segment-conditioned quality head over the flat location grid."""

    def __init__(self, cfg: ModelConfig, ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        mix_in = [3 * d] + [d] * (cfg.iou_head_layers - 1)
        self.iou_mix = nn.ModuleList(
            [ConvBlock(cfg, mix_in[i], d, 1, ops=ops)
             for i in range(cfg.iou_head_layers)])
        self.iou_out = nn.Conv1d(d, 1, 1)

    def forward(self, pyramid: List[torch.Tensor], segments: torch.Tensor,
                level_ids: torch.Tensor, strides: torch.Tensor):
        """segments (B, N, 2) base-grid units; level_ids, strides (N,)."""
        pos = segment_positions([p.shape[1] for p in pyramid], segments,
                                level_ids, strides)
        x = segment_samples(pyramid, pos).to(cdt(self.cfg))  # (B, N, 3D)
        return self.mix(x, 0)

    def mix(self, x: torch.Tensor, first: int) -> torch.Tensor:
        """The mixes from `first` on, then the output conv: (B, N) fp32."""
        for blk in self.iou_mix[first:]:
            x = blk(x)
        return same_conv(x, self.iou_out, cdt(self.cfg)).float()[..., 0]
