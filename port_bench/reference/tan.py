"""2D-TAN's forward pass in plain PyTorch, fp32 throughout.

Written from the model's equations (Zhang, Peng, Fu and Luo, AAAI 2020,
arXiv:1912.03590; its TACoS model "128x128-K5L8-pool"), not from the
program (`drn_tpu_torch/models/tan.py`): it imports nothing of the program
and nothing of JAX, and takes no tensor the program made. The parameters
are a dict under the program's names (`frame.weight`,
`query_encoder.lstm.weight_ih_l0`, `map_conv.convs.3.weight`, ...), which
the benchmark draws from the seed and hands to both sides.

  query     embedding → stacked unidirectional LSTM (hidden D) → the state
            at the last valid word → Linear D → D
  clips     relu(W_f · x_t + b_f) for each clip t, averaged over groups of
            `frame_pool` consecutive clips: N = num_clips / frame_pool
  map       cell (a, b), a ≤ b: the max over clip features a..b where
            (a, b) is a valid moment, 0 elsewhere. Valid (`valid_mask`):
            with the scale layers [s_0, s_1, ...], scale j (stride 2**j)
            adds the lengths L = top_j + i·2**j, i = 1..s_j, each at the
            starts a divisible by 2**j (top_0 = 0, top_j+1 = top_j +
            s_j·2**j): for [16, 8, 8, 8] and N = 128, L ≤ 16 anywhere, L
            in 18..32 step 2 at even a, 36..64 step 4 at a % 4 = 0, 72..128
            step 8 at a % 8 = 0: 2,548 moments
  fusion    normalize over channels (eps 1e-12) of txt ⊙ (W_v · map + b_v),
            a 1×1 conv at every cell, times the valid mask
  map conv  for each layer l: x ← relu(conv2d(x, W_l, b_l, padding p_l)) ·
            w_l, w_l = 1 / (the live cells of the previous layer's mask in
            the kernel's window), 0 where there are none; the mask after
            layer l is w_l > 0 (layer 0's is the valid mask)
  pred      W_p · x + b_p (1×1 conv) times the valid mask; the logits are
            read at the valid moments in row-major order (a, then b)

Segments are the moments in the clip grid, (frame_pool · a,
frame_pool · (b + 1)).

Every product goes through `q(x)` on both operands, as in
reference/model.py: the precision control (reference/lowp.py) is this code
computed on fp8 operands. Run with TF32 off (`model.fp32_mode()`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from port_bench.reference import model as ref
from port_bench.reference.model import Params, Round, identity

EPS = 1e-12


def map_size(dims) -> int:
    return dims["num_clips"] // dims["frame_pool"]


def valid_mask(n: int, scale_layers: Sequence[int]) -> torch.Tensor:
    """(n, n) bool, from the closed-form rule above."""
    mask = torch.zeros(n, n, dtype=torch.bool)
    top = 0
    for j, layers in enumerate(scale_layers):
        stride = 2 ** j
        for i in range(1, layers + 1):
            length = top + i * stride
            for a in range(0, n - length + 1, stride):
                mask[a, a + length - 1] = True
        top += layers * stride
    return mask


def count_weights(mask: torch.Tensor, kernel: int,
                  paddings: Sequence[int]) -> List[torch.Tensor]:
    """w_l of each map conv: for every output cell, the live cells of the
    previous mask (zero padded by p_l) in its kernel × kernel window."""
    weights, live = [], mask.float()
    for p in paddings:
        padded = F.pad(live, (p, p, p, p))
        n_out = padded.shape[0] - kernel + 1
        count = torch.zeros(n_out, n_out)
        for i in range(kernel):
            for j in range(kernel):
                count += padded[i:i + n_out, j:j + n_out]
        w = torch.where(count > 0, 1.0 / count.clamp_min(1.0),
                        torch.zeros_like(count))
        weights.append(w)
        live = (count > 0).float()
    return weights


def query(p: Params, dims, word_ids, query_mask, q: Round = identity):
    """(B, L) → (B, D)."""
    h = F.embedding(word_ids.long(), p["query_encoder.embed.weight"])
    for layer in range(dims["num_lstm_layers"]):
        sub = {f"l.{k}_l0": p[f"query_encoder.lstm.{k}_l{layer}"]
               for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        h = ref.lstm(sub, "l", h, q)
    last = query_mask.long().sum(-1).clamp(min=1) - 1
    h = h[torch.arange(h.shape[0], device=h.device), last]
    return q(h) @ q(p["query_encoder.proj.weight"]).t() \
        + p["query_encoder.proj.bias"]


def clips(p: Params, dims, features, q: Round = identity):
    """(B, T, F) → (B, N, D)."""
    b, t, _ = features.shape
    v = torch.relu(q(features) @ q(p["frame.weight"]).t() + p["frame.bias"])
    return v.view(b, map_size(dims), dims["frame_pool"], -1).mean(2)


def moment_map(v, mask):
    """(B, N, D) → (B, D, N, N): cell (a, b) the max over v[a..b] where
    mask[a, b], else 0."""
    b, n, d = v.shape
    out = v.new_zeros((b, d, n, n))
    running = v
    for length in range(1, n + 1):
        if length > 1:   # running[:, a] = max over v[a .. a + length − 1]
            running = torch.maximum(running[:, :-1], v[:, length - 1:])
        starts = torch.nonzero(torch.diagonal(mask, length - 1))[:, 0]
        if len(starts):
            out[:, :, starts.to(v.device), (starts + length - 1).to(v.device)] \
                = running[:, starts.to(v.device)].transpose(1, 2)
    return out


def forward(p: Params, dims, features, word_ids, query_mask,
            q: Round = identity) -> Dict[str, torch.Tensor]:
    """→ match_logits (B, K) and segments (B, K, 2) in the clip grid."""
    dev = features.device
    n, k = map_size(dims), dims["map_kernel_size"]
    mask = valid_mask(n, dims["scale_layers"])
    weights = count_weights(mask, k, dims["map_paddings"])
    mask_d = mask.to(dev)

    txt = query(p, dims, word_ids, query_mask, q)
    m = moment_map(clips(p, dims, features, q), mask_d)
    vis = torch.einsum("bchw,oc->bohw", q(m), q(p["vis_conv.weight"])) \
        + p["vis_conv.bias"][None, :, None, None]
    f = txt[:, :, None, None] * vis
    f = f / f.norm(dim=1, keepdim=True).clamp_min(EPS)
    x = f * mask_d
    for l, pad in enumerate(dims["map_paddings"]):
        y = F.conv2d(q(x), q(p[f"map_conv.convs.{l}.weight"]),
                     p[f"map_conv.convs.{l}.bias"], padding=pad)
        x = torch.relu(y) * weights[l].to(dev)
    logits = torch.einsum("bchw,oc->bohw", q(x), q(p["pred.weight"]))[:, 0] \
        + p["pred.bias"]
    logits = logits * mask_d
    a, b = torch.nonzero(mask, as_tuple=True)
    segments = torch.stack([a, b + 1], -1).float().to(dev) \
        * dims["frame_pool"]
    return {"match_logits": logits[:, a.to(dev), b.to(dev)],
            "segments": segments.expand(features.shape[0], -1, -1)}
