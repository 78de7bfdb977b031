"""2D-TAN (Zhang, Peng, Fu and Luo, "Learning 2D Temporal Adjacent
Networks for Moment Localization with Natural Language", AAAI 2020,
arXiv:1912.03590), the eval path of the port:

    features (B, T, F), word_ids (B, L), query_mask (B, L)
      → query encoder → (B, D): embedding → unidirectional LSTM (cuDNN,
                        fp32) → the state at the last valid word → Linear
      → frame         → (B, N, D): k=1 conv + ReLU, average pool of
                        `frame_pool` clips (N = T / frame_pool)
      → map build     → (B, K, D): each valid moment (a, b), the max over
                        clip features a..b
      → fusion        → (B, N, N, D): normalize(txt ⊙ (W·m + b)) over the
                        channels at the valid cells, 0 elsewhere
      → map conv      → `map_layers` × [2-D conv (cuDNN, bf16
                        channels-last, fp32 accumulation), then
                        relu(· + bias) · w_l in one pass
                        (ops/cuda/map_epilogue.py)]
      → pred          → match logits (B, K) fp32 at the valid moments

The K valid moments are the cells the published SparsePropMaxPool fills:
its scale layers (`scale_layers`, e.g. [16, 8, 8, 8]) are stacked 1-D max
pools, the first of scale 0 of width 1, the first of every later scale of
width 3 and stride 2, the rest of width 2 and stride 1; each pool's output
t covers the clips of a window, and each window is a moment. They are
listed in row-major order (start, then end), the order of every (B, K)
output. A moment's feature is the max over its clips; the port takes it
from a sparse table (the max over the 2**k clips from t, for each k) as
the larger of two overlapping power-of-two windows: the same value.

w_l, the count weights after map conv l: 1 / (the live cells of the
previous layer's mask in the conv's window, the zero padding dead), 0
where there are none; a cell is live after layer l where w_l > 0; the
valid moments are layer 0's live cells. The weights depend on the
configuration alone: buffers, made once.

The 1×1 convs (vis_conv, pred) act cell by cell: where the mask zeroes
their output (the fusion's product with the mask, the prediction's), the
port leaves them out. Segments are the moments in the clip grid,
(frame_pool · a, frame_pool · (b + 1)).

While a profiler session records, the parts are the program's ranges
`drn.model.{query_encoder,frame,map_build,fusion,map_conv,pred}`
(utils/profiling.py::span). The epilogue's counter `map_epilogue.cells`
(ops/cuda/map_epilogue.py) counts the map convs' output cells: B × Σ_l
H_l·W_l a forward.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from drn_tpu_torch.config import TANModelConfig
from drn_tpu_torch.ops.cuda.map_epilogue import map_epilogue
from drn_tpu_torch.utils.profiling import span

NORM_EPS = 1e-12  # F.normalize's default, as the published fusion


def moment_cells(n: int, scale_layers: Sequence[int]) -> List[Tuple[int, int]]:
    """The (start, end) clip pairs of the map of n clips that the stacked
    pools of `scale_layers` fill, row-major."""
    cells, length, stride = [], 0, 1
    for scale, layers in enumerate(scale_layers):
        for i in range(layers):
            if scale and i == 0:
                stride *= 2
            length += stride
            cells += [(a, a + length - 1)
                      for a in range(0, n - length + 1, stride)]
    return sorted(cells)


def valid_mask(n: int, scale_layers: Sequence[int]) -> torch.Tensor:
    """(n, n) bool: the valid moments."""
    mask = torch.zeros(n, n, dtype=torch.bool)
    for a, b in moment_cells(n, scale_layers):
        mask[a, b] = True
    return mask


def count_weights(mask: torch.Tensor, kernel: int,
                  paddings: Sequence[int]) -> List[torch.Tensor]:
    """w_l (H_l, W_l) fp32 of each map conv, from layer 0's (n, n) mask."""
    out, live = [], mask.double()[None, None]
    ones = torch.ones(1, 1, kernel, kernel, dtype=torch.float64)
    for p in paddings:
        count = torch.round(F.conv2d(live, ones, padding=p))[0, 0]
        w = torch.where(count > 0, 1.0 / count.clamp_min(1.0),
                        torch.zeros_like(count))
        out.append(w.float())
        live = (count > 0).double()[None, None]
    return out


def _compute_dtype(cfg: TANModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class TANQueryEncoder(nn.Module):
    """Embedding → `num_lstm_layers` unidirectional LSTM (hidden D, cuDNN,
    fp32) → its output at each row's last valid word → Linear D → D."""

    def __init__(self, cfg: TANModelConfig, freeze_embeddings: bool = False):
        super().__init__()
        self.freeze_embeddings = freeze_embeddings
        d = cfg.hidden_dim
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.lstm = nn.LSTM(cfg.embed_dim, d, num_layers=cfg.num_lstm_layers,
                            batch_first=True)
        self.proj = nn.Linear(d, d)

    def forward(self, word_ids: torch.Tensor,
                query_mask: torch.Tensor) -> torch.Tensor:
        table = self.embed.weight
        if self.freeze_embeddings:
            table = table.detach()
        h = self.lstm(F.embedding(word_ids.long(), table).float())[0]
        last = query_mask.long().sum(-1).clamp(min=1) - 1
        h = torch.gather(h, 1, last[:, None, None].expand(-1, 1, h.shape[-1]))
        return self.proj(h[:, 0])


class MapConv(nn.Module):
    """The masked 2-D conv stack on a (B, N, N, D) map; → (B, N, N, D)."""

    def __init__(self, cfg: TANModelConfig, n: int):
        super().__init__()
        d, k = cfg.hidden_dim, cfg.map_kernel_size
        self.paddings = tuple(cfg.map_paddings)
        self.convs = nn.ModuleList(
            [nn.Conv2d(d, d, k, padding=p) for p in self.paddings])
        weights = count_weights(valid_mask(n, cfg.scale_layers), k,
                                self.paddings)
        if weights[-1].shape != (n, n):
            raise ValueError(f"map_paddings {self.paddings} with kernel {k} "
                             f"end at {tuple(weights[-1].shape)}, not the "
                             f"map's {(n, n)}")
        for l, w in enumerate(weights):
            self.register_buffer(f"count_weight_{l}", w, persistent=False)
        self.dtype = _compute_dtype(cfg)

    def count_weight(self, layer: int) -> torch.Tensor:
        return getattr(self, f"count_weight_{layer}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        for l, conv in enumerate(self.convs):
            w = conv.weight.to(self.dtype, memory_format=torch.channels_last)
            y = F.conv2d(h, w, None, padding=self.paddings[l])
            y = y.contiguous(memory_format=torch.channels_last)
            map_epilogue(y.permute(0, 2, 3, 1), conv.bias.float(),
                         self.count_weight(l))
            h = y
        return h.permute(0, 2, 3, 1)


class TAN(nn.Module):
    def __init__(self, cfg: TANModelConfig, num_clips: int,
                 freeze_embeddings: bool = False):
        super().__init__()
        if num_clips % cfg.frame_pool:
            raise ValueError(f"num_clips={num_clips} does not pool by "
                             f"frame_pool={cfg.frame_pool}")
        self.cfg, self.base_len = cfg, num_clips
        n = self.n = num_clips // cfg.frame_pool
        d = cfg.hidden_dim
        self.dtype = _compute_dtype(cfg)
        self.query_encoder = TANQueryEncoder(cfg, freeze_embeddings)
        self.frame = nn.Linear(cfg.feature_dim, d)      # the k=1 conv
        self.vis_conv = nn.Linear(d, d)                 # the fusion's 1×1
        self.map_conv = MapConv(cfg, n)
        self.pred = nn.Linear(d, 1)                     # the 1×1 prediction
        self.mesh = None  # never split (config.require_drn)

        cells = torch.tensor(moment_cells(n, cfg.scale_layers))
        a, b = cells[:, 0], cells[:, 1]
        level = torch.floor(torch.log2((b - a + 1).double())).long()
        self.levels = int(level.max()) + 1
        self.register_buffer("cell_flat", a * n + b, persistent=False)
        # The moment's max as the larger of the two 2**level windows that
        # start at a and end at b: rows of the sparse table (levels, n).
        self.register_buffer("table_lo", level * n + a, persistent=False)
        self.register_buffer("table_hi", level * n + b + 1 - 2 ** level,
                             persistent=False)
        self.register_buffer("segments", torch.stack(
            [a, b + 1], -1).float() * cfg.frame_pool, persistent=False)

    @property
    def num_moments(self) -> int:
        return self.cell_flat.numel()

    def frame_features(self, features: torch.Tensor) -> torch.Tensor:
        """(B, T, F) → (B, N, D) in the compute dtype."""
        bsz, t, _ = features.shape
        y = F.linear(features.to(self.dtype), self.frame.weight.to(self.dtype))
        y = torch.relu(y.float() + self.frame.bias)
        return y.view(bsz, self.n, t // self.n, -1).mean(2).to(self.dtype)

    def build_map(self, v: torch.Tensor) -> torch.Tensor:
        """(B, N, D) → each valid moment's max over its clips (B, K, D)."""
        bsz, n, d = v.shape
        table = v.new_empty((bsz, self.levels, n, d))
        table[:, 0] = v
        for k in range(1, self.levels):
            half = 2 ** (k - 1)
            table[:, k, :n - half] = torch.maximum(table[:, k - 1, :n - half],
                                                   table[:, k - 1, half:])
        flat = table.view(bsz, self.levels * n, d)
        return torch.maximum(flat.index_select(1, self.table_lo),
                             flat.index_select(1, self.table_hi))

    def fuse(self, m: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        """(B, K, D) moments, (B, D) query → the (B, N, N, D) map."""
        bsz, _, d = m.shape
        y = F.linear(m, self.vis_conv.weight.to(self.dtype))
        f = (y.float() + self.vis_conv.bias) * txt[:, None, :]
        f = f / f.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS)
        out = m.new_zeros((bsz, self.n * self.n, d))
        out.index_copy_(1, self.cell_flat, f.to(self.dtype))
        return out.view(bsz, self.n, self.n, d)

    def predict(self, h: torch.Tensor) -> torch.Tensor:
        """(B, N, N, D) → the logits at the valid moments (B, K) fp32."""
        bsz, _, _, d = h.shape
        x = h.reshape(bsz, self.n * self.n, d).index_select(1, self.cell_flat)
        return (x.float() @ self.pred.weight.t())[..., 0] + self.pred.bias

    def forward(self, features, word_ids, query_mask) -> Dict[str, torch.Tensor]:
        with span("model.query_encoder"):
            txt = self.query_encoder(word_ids, query_mask)
        with span("model.frame"):
            v = self.frame_features(features)
        with span("model.map_build"):
            m = self.build_map(v)
        with span("model.fusion"):
            x = self.fuse(m, txt)
        with span("model.map_conv"):
            h = self.map_conv(x)
        with span("model.pred"):
            logits = self.predict(h)
        return {
            "match_logits": logits,  # (B, K)
            "segments": self.segments.expand(logits.shape[0], -1, -1),
        }
