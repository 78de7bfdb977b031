"""The assembled DRN (port of drn_tpu/models/drn.py).

    features (B, T, F), word_ids (B, L), query_mask (B, L)
      → query encoder → per-level query vectors
      → backbone      → per-level video features     [fused_stem, conv_ln_relu]
      → fusion        → query-conditioned levels     [fused_fusion_block]
      → temporal FPN  → pyramid                      [conv_ln_relu]
      → heads         → (d_start, d_end), match logits, IoU logits
                                                     [conv_ln_relu]

`state_dict()` / `load_state_dict()` use the flat `TorchDRNParity` schema
(keys such as `stem.conv.weight`, `fusion_conv.0.bias`, `scales`), so a
reference-schema `.pth` loads directly: each submodule's parameter names
are unique across submodules, and the submodule prefix is dropped.

Under a mesh with a model or time axis (`set_mesh`, called by
parallel/sharding.py::shard_model) the backbone, the fusion and the FPN
run on this rank's block of the clip axis, and each pyramid level is
gathered whole before the heads; the heads, the IoU head's sampling
(which reads any position of a level), decode and scoring then run the
same on every time rank. The layers whose weights are split run on their
output-channel block (models/layers.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.models.backbone import Backbone
from drn_tpu_torch.models.fpn import TemporalFPN
from drn_tpu_torch.models.fusion import CrossModalFusion
from drn_tpu_torch.models.heads import GroundingHeads, IoUHead
from drn_tpu_torch.models.layers import KERNEL_OPS, WHOLE, Axes, ConvBlock, Ops
from drn_tpu_torch.ops.cuda.conv_block import KERNEL_COUTS
from drn_tpu_torch.parallel.collectives import gather_time
from drn_tpu_torch.models.query_encoder import QueryEncoder
from drn_tpu_torch.ops.temporal import decode_segments, pyramid_locations

_PARTS = ("query_encoder", "backbone", "fusion", "fpn", "heads", "iou_head")


def location_metadata(cfg: ModelConfig, base_len: int, device=None):
    """Flat per-location (locations, strides, level_ids), level-major."""
    locs = torch.cat(pyramid_locations(base_len, cfg.num_levels, device))
    sizes = [base_len // 2 ** l for l in range(cfg.num_levels)]
    strides = np.concatenate([np.full((t,), float(2 ** l), np.float32)
                              for l, t in enumerate(sizes)])
    level_ids = np.concatenate([np.full((t,), l, np.int64)
                                for l, t in enumerate(sizes)])
    return (locs, torch.as_tensor(strides, device=device),
            torch.as_tensor(level_ids, device=device))


def conv_block_sites(cfg: ModelConfig, base_len: int):
    """Every `conv_ln_relu` launch of one forward, in model order: (site,
    T_in, Cin, K, stride, use_norm, use_act). Backbone levels (strides 1,
    2, 2, ...), FPN laterals (k=1, no ReLU) and smooths, the head towers
    on the gap-padded concat of the levels, the IoU head's k=1 mixes."""
    d = cfg.hidden_dim
    sizes = [base_len // 2 ** l for l in range(cfg.num_levels)]
    sites, t_in = [], base_len
    for l in range(cfg.num_levels):
        sites.append((f"level_{l}", t_in, d, 3, 1 if l == 0 else 2, True,
                      True))
        t_in = sizes[l]
    sites += [(f"lateral_{l}", s, d, 1, 1, True, False)
              for l, s in enumerate(sizes)]
    sites += [(f"smooth_{l}", s, d, 3, 1, True, True)
              for l, s in enumerate(sizes)]
    gap_t = sum(sizes) + cfg.num_levels - 1
    sites += [(f"{tw}_tower_{i}", gap_t, d, 3, 1, True, True)
              for tw in ("loc", "match")
              for i in range(cfg.head_tower_layers)]
    sites += [(f"iou_mix_{i}", sum(sizes), 3 * d if i == 0 else d, 1, 1, True,
               True) for i in range(cfg.iou_head_layers)]
    return sites


class DRN(nn.Module):
    def __init__(self, cfg: ModelConfig, base_len: int,
                 ops: Ops = KERNEL_OPS, freeze_embeddings: bool = False):
        super().__init__()
        if base_len % (2 ** (cfg.num_levels - 1)):
            raise ValueError("num_clips must be divisible by the coarsest "
                             "pyramid stride")
        self.cfg, self.base_len = cfg, base_len
        self.query_encoder = QueryEncoder(cfg, freeze_embeddings)
        self.backbone = Backbone(cfg, ops)
        self.fusion = CrossModalFusion(cfg, ops)
        self.fpn = TemporalFPN(cfg, ops)
        self.heads = GroundingHeads(cfg, ops)
        self.iou_head = IoUHead(cfg, ops)
        locs, strides, level_ids = location_metadata(cfg, base_len)
        self.register_buffer("locations", locs, persistent=False)
        self.register_buffer("strides", strides, persistent=False)
        self.register_buffer("level_ids", level_ids, persistent=False)
        self._owner = {k.split(".")[0]: part for part in _PARTS
                       for k in getattr(self, part).state_dict()}
        self.mesh, self.specs = None, None

    def set_mesh(self, mesh, specs) -> None:
        """Give every layer its `Axes` under `mesh` (None: whole again):
        the model group where `specs` (parallel/sharding.py) splits its
        weight, the time group for the backbone, fusion and FPN layers.
        On a CUDA model a split conv kernel's block of output channels
        must be one the kernels build (KERNEL_COUTS): another raises
        here, naming the layer."""
        self.mesh, self.specs = mesh, specs
        on_card = next(self.parameters()).device.type == "cuda"

        def axes(part: str, key: str, cout: int) -> Axes:
            if mesh is None:
                return WHOLE
            split = specs[key] is not None
            if split and on_card and cout // mesh.model_axis \
                    not in KERNEL_COUTS:
                raise ValueError(
                    f"{key}: {cout} output channels over model_axis="
                    f"{mesh.model_axis} leave blocks of "
                    f"{cout // mesh.model_axis}; the kernels take "
                    f"{KERNEL_COUTS}")
            return Axes(mesh.model_group if split else None,
                        mesh.time_group if part in ("backbone", "fusion",
                                                    "fpn") else None)

        for part in ("backbone", "fpn", "heads", "iou_head"):
            for name, m in getattr(self, part).named_modules():
                if isinstance(m, ConvBlock):
                    m.axes = axes(part, f"{name}.conv.weight",
                                  m.conv.out_channels)
        fu = self.fusion
        fu.axes = [axes("fusion", f"fusion_conv.{l}.weight",
                        c.out_channels)
                   for l, c in enumerate(fu.fusion_conv)]
        qe = self.query_encoder
        g = None if mesh is None else mesh.model_group
        qe.lstm_group = g if mesh and specs["lstm_fwd.0.weight_hh_l0"] \
            is not None else None
        qe.proj_group = g if mesh and specs["query_proj.0.weight"] \
            is not None else None

    def owner(self, key: str) -> str:
        """The submodule (one of query_encoder, backbone, fusion, fpn,
        heads, iou_head) that holds the parity-schema parameter `key`."""
        return self._owner[key.split(".")[0]]

    def state_dict(self, keep_vars: bool = False):
        """Flat parity-schema keys (submodule prefix dropped)."""
        return OrderedDict(
            (k.split(".", 1)[1], v)
            for k, v in super().state_dict(keep_vars=keep_vars).items())

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        unknown = [k for k in state_dict if k.split(".")[0] not in self._owner]
        if unknown and strict:
            raise KeyError(f"keys outside the parity schema: {unknown[:5]}")
        sd = {f"{self._owner[k.split('.')[0]]}.{k}": v
              for k, v in state_dict.items() if k not in unknown}
        return super().load_state_dict(sd, strict=strict, assign=assign)

    def forward(self, features, word_ids, query_mask) -> Dict[str, torch.Tensor]:
        queries = self.query_encoder(word_ids, query_mask)
        v_levels = self.backbone(features)
        fused = self.fusion(v_levels, queries)
        pyramid = self.fpn(fused)
        if self.mesh is not None and self.mesh.time_axis > 1:
            pyramid = [gather_time(p, self.mesh.time_group) for p in pyramid]
        d_start, d_end, match_logits = self.heads(pyramid)
        # No gradient through the IoU head's sampling positions (the
        # two-stage recipe), as the JAX package's stop_gradient.
        segments = decode_segments(self.locations, d_start, d_end,
                                   float(self.base_len)).detach()
        iou_logits = self.iou_head(pyramid, segments, self.level_ids,
                                   self.strides)
        return {
            "d_start": d_start,            # (B, N) base-grid units
            "d_end": d_end,                # (B, N)
            "match_logits": match_logits,  # (B, N)
            "iou_logits": iou_logits,      # (B, N)
            "segments": segments,          # (B, N, 2) base-grid units
        }
