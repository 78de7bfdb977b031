"""Query encoder (port of drn_tpu/models/query_encoder.py): word embeddings
→ multi-layer BiLSTM → one pooled, projected query vector per level.

No Pallas kernel covers the encoder, so the recurrence is `nn.LSTM`
(cuDNN on the card), in fp32. The reverse direction runs over each row's
valid prefix flipped in place (padding stays where it is), as flax's
`flip_sequences` does; outputs at padded positions are masked out of the
pool, so only valid positions have to agree with the JAX package.

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
            f, _ = fwd(h)
            r, _ = bwd(masked_reverse(h, lengths))
            h = torch.cat([f, masked_reverse(r, lengths)], dim=-1)
            outs.append(h)
        mask_f = query_mask[..., None].float()
        denom = mask_f.sum(1).clamp(min=1.0)
        queries = []
        for level in range(cfg.num_levels):
            src = outs[min(level, cfg.num_lstm_layers - 1)]
            pooled = (src * mask_f).sum(1) / denom
            queries.append(torch.tanh(self.query_proj[level](pooled)))
        return queries
