"""Query encoder (port of drn_tpu/models/query_encoder.py): word embeddings
→ multi-layer BiLSTM → one pooled, projected query vector per level.

No Pallas kernel covers the encoder, so the recurrence is `nn.LSTM`
(cuDNN on the card), in fp32. The reverse direction runs over each row's
valid prefix flipped in place (padding stays where it is), as flax's
`flip_sequences` does; outputs at padded positions are masked out of the
pool, so only valid positions have to agree with the JAX package.

Under a model axis the `query_proj_l` Linears run column-parallel
(this rank's output rows, then gathered) and the LSTMs' weights are kept
in gate blocks (parallel/sharding.py): cuDNN's LSTM cannot run on a split
gate matrix, so each is reassembled, gate block by gate block, right
before its call (`gather_blocks`, whose gradient is sliced back to this
rank's block). The encoder runs whole on every rank of both axes.

GloVe mode (`freeze_embeddings=True`, the table holding the pretrained
rows): the table is read detached, as the JAX package's stop_gradient, so
no gradient reaches it; the optimizer then sees a zero gradient for it.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from drn_tpu_torch.config import ModelConfig
from drn_tpu_torch.parallel.collectives import (gather_channels,
                                                split_channels, sum_grad)
from drn_tpu_torch.parallel.sharding import gather_blocks


def masked_reverse(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Flip each row's first `lengths[b]` steps; the tail stays in place."""
    b, l, _ = x.shape
    idx = torch.arange(l, device=x.device)[None, :].expand(b, l)
    rev = torch.where(idx < lengths[:, None], lengths[:, None] - 1 - idx, idx)
    return torch.gather(x, 1, rev[..., None].expand_as(x))


class QueryEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, freeze_embeddings: bool = False):
        super().__init__()
        self.cfg = cfg
        self.freeze_embeddings = freeze_embeddings
        d, half = cfg.hidden_dim, cfg.hidden_dim // 2
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        in_dims = [cfg.embed_dim] + [d] * (cfg.num_lstm_layers - 1)
        self.lstm_fwd = nn.ModuleList(
            [nn.LSTM(i, half, batch_first=True) for i in in_dims])
        self.lstm_bwd = nn.ModuleList(
            [nn.LSTM(i, half, batch_first=True) for i in in_dims])
        # flax's LSTM cell has one bias per gate: it lives in bias_ih_l0,
        # and bias_hh_l0 stays a constant (zero from the weight bridge), so
        # training updates the same parameters as the JAX package.
        for lstm in (*self.lstm_fwd, *self.lstm_bwd):
            lstm.bias_hh_l0.requires_grad_(False)
        self.query_proj = nn.ModuleList(
            [nn.Linear(d, d) for _ in range(cfg.num_levels)])
        # The model group when the LSTM weights (`lstm_group`) or the
        # projections' (`proj_group`) are split over it.
        self.lstm_group = self.proj_group = None

    def _lstm(self, lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
        if self.lstm_group is None:
            return lstm(x)[0]
        # nn.LSTM runs on its `_flat_weights`: the whole weights stand in
        # for the blocks during the call.
        flat = lstm._flat_weights
        lstm._flat_weights = [
            gather_blocks(p, n, self.lstm_group) if n.startswith("weight")
            else p for n, p in zip(lstm._flat_weights_names, flat)]
        try:
            return lstm(x)[0]
        finally:
            lstm._flat_weights = flat

    def _proj(self, level: int, pooled: torch.Tensor) -> torch.Tensor:
        proj, g = self.query_proj[level], self.proj_group
        if g is None:
            return torch.tanh(proj(pooled))
        y = F.linear(sum_grad(pooled, g), proj.weight,
                     split_channels(proj.bias, g))
        return gather_channels(torch.tanh(y), g)

    def forward(self, word_ids: torch.Tensor,
                query_mask: torch.Tensor) -> List[torch.Tensor]:
        """word_ids (B, L) int, query_mask (B, L) bool → [(B, D) fp32]."""
        cfg = self.cfg
        table = self.embed.weight
        if self.freeze_embeddings:
            table = table.detach()
        h = F.embedding(word_ids.long(), table).float()
        lengths = query_mask.long().sum(-1).clamp(min=1)
        outs = []
        for fwd, bwd in zip(self.lstm_fwd, self.lstm_bwd):
            f = self._lstm(fwd, h)
            r = self._lstm(bwd, masked_reverse(h, lengths))
            h = torch.cat([f, masked_reverse(r, lengths)], dim=-1)
            outs.append(h)
        mask_f = query_mask[..., None].float()
        denom = mask_f.sum(1).clamp(min=1.0)
        queries = []
        for level in range(cfg.num_levels):
            src = outs[min(level, cfg.num_lstm_layers - 1)]
            pooled = (src * mask_f).sum(1) / denom
            queries.append(self._proj(level, pooled))
        return queries
