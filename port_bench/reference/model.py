"""The DRN forward pass in plain PyTorch, fp32 throughout.

An independent rewrite of the model that `drn_tpu_torch` serves (query
encoder, backbone, fusion, temporal FPN, grounding heads, IoU head and the
segment decode), written from the architecture's equations. It imports
nothing of the program and takes no tensor the program made: the
parameters are a dict in the program's checkpoint schema (keys such as
`stem.conv.weight`, `fusion_conv.0.bias`, `lstm_fwd.1.weight_ih_l0`), which
the benchmark draws from the seed and hands to both sides.

Every matrix product goes through `q(x)` on both operands. The reference
passes the identity; the precision control (reference/lowp.py) passes a
rounding to a lower precision, so the control is this very code computed
in that precision.

`dims` is the configuration file's `model` block plus `num_clips`
(port_bench/configs/<config>.json).

Run with TF32 off (`fp32_mode()`): on an H100 an fp32 product may
otherwise run in TF32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def fp32_mode():
    """TF32 off for products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def layer_norm(x, scale, offset):
    """LayerNorm over the last axis, variance as E[x²] − E[x]² (clamped at
    0), eps 1e-6."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + LN_EPS) * scale) + offset


def same_padding(t: int, k: int, stride: int):
    """'SAME' padding: (out_t, left, right), the odd row on the right."""
    out_t = -(-t // stride)
    total = max((out_t - 1) * stride + k - t, 0)
    return out_t, total // 2, total - total // 2


def conv1d(x, w, b, stride: int = 1, q: Round = identity):
    """SAME conv of x (B, T, Cin) with w (Cout, Cin, K) → (B, T_out, Cout):
    one product per tap."""
    k = w.shape[2]
    out_t, left, right = same_padding(x.shape[1], k, stride)
    xq = q(F.pad(x, (0, 0, left, right)))
    wq = q(w)
    span = (out_t - 1) * stride + 1
    acc = b
    for i in range(k):
        acc = acc + xq[:, i:i + span:stride] @ wq[:, :, i].t()
    return acc


def block(p: Params, name: str, x, stride: int = 1, norm: bool = True,
          act: bool = True, q: Round = identity):
    y = conv1d(x, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], stride, q)
    if norm:
        y = layer_norm(y, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"])
    return torch.relu(y) if act else y


def level_sizes(dims) -> List[int]:
    return [dims["num_clips"] // 2 ** l for l in range(dims["num_levels"])]


# ---------------------------------------------------------------- encoder
def lstm(p: Params, name: str, x, q: Round = identity):
    """One LSTM layer over x (B, L, In) from zero state; gates i, f, g, o."""
    w_ih, w_hh = p[f"{name}.weight_ih_l0"], p[f"{name}.weight_hh_l0"]
    bias = p[f"{name}.bias_ih_l0"] + p[f"{name}.bias_hh_l0"]
    b, n, _ = x.shape
    hid = w_hh.shape[1]
    xw = q(x) @ q(w_ih).t() + bias                       # (B, L, 4H)
    w_hh = q(w_hh)
    h = x.new_zeros((b, hid))
    c = x.new_zeros((b, hid))
    outs = []
    for t in range(n):
        gates = xw[:, t] + q(h) @ w_hh.t()
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def reverse_prefix(x, lengths):
    """Each row's first `lengths[b]` steps flipped; the tail in place."""
    b, n, _ = x.shape
    idx = torch.arange(n, device=x.device)[None, :].expand(b, n)
    rev = torch.where(idx < lengths[:, None], lengths[:, None] - 1 - idx, idx)
    return torch.gather(x, 1, rev[..., None].expand_as(x))


def query_encoder(p: Params, dims, word_ids, query_mask,
                  q: Round = identity) -> List[torch.Tensor]:
    """Embedding → stacked bidirectional LSTMs (the backward direction over
    each row's valid prefix) → per level, the masked mean of one layer's
    output, projected and squashed: [(B, D)] one a level."""
    h = F.embedding(word_ids.long(), p["embed.weight"])
    lengths = query_mask.long().sum(-1).clamp(min=1)
    outs = []
    for layer in range(dims["num_lstm_layers"]):
        f = lstm(p, f"lstm_fwd.{layer}", h, q)
        r = lstm(p, f"lstm_bwd.{layer}", reverse_prefix(h, lengths), q)
        h = torch.cat([f, reverse_prefix(r, lengths)], dim=-1)
        outs.append(h)
    m = query_mask[..., None].float()
    denom = m.sum(1).clamp(min=1.0)
    queries = []
    for level in range(dims["num_levels"]):
        src = outs[min(level, dims["num_lstm_layers"] - 1)]
        pooled = (src * m).sum(1) / denom
        queries.append(torch.tanh(q(pooled) @ q(p[f"query_proj.{level}.weight"]).t()
                                  + p[f"query_proj.{level}.bias"]))
    return queries


# ------------------------------------------------------- video and fusion
def backbone(p: Params, dims, features, q: Round = identity):
    """Input LayerNorm, stem conv block, one conv block a level (strides 1,
    2, 2, ...) → [(B, T / 2**l, D)]."""
    x = layer_norm(features, p["input_norm.weight"], p["input_norm.bias"])
    x = block(p, "stem", x, q=q)
    levels = []
    for l in range(dims["num_levels"]):
        x = block(p, f"levels.{l}", x, stride=1 if l == 0 else 2, q=q)
        levels.append(x)
    return levels


def fusion(p: Params, dims, levels, queries, q: Round = identity):
    """Per level relu(LN(conv(v ⊙ q_l) + b))."""
    out = []
    for l, (v, qv) in enumerate(zip(levels, queries)):
        y = conv1d(v * qv[:, None, :], p[f"fusion_conv.{l}.weight"],
                   p[f"fusion_conv.{l}.bias"], 1, q)
        out.append(torch.relu(layer_norm(y, p[f"fusion_norm.{l}.weight"],
                                         p[f"fusion_norm.{l}.bias"])))
    return out


def fpn(p: Params, dims, fused, q: Round = identity):
    """k=1 laterals (LN, no ReLU), nearest 2× upsampling top-down, k=3
    smoothing blocks."""
    n = len(fused)
    lat = [block(p, f"lateral.{l}", fused[l], act=False, q=q)
           for l in range(n)]
    outs = [None] * n
    outs[-1] = lat[-1]
    for l in range(n - 2, -1, -1):
        outs[l] = lat[l] + outs[l + 1].repeat_interleave(2, dim=1)
    return [block(p, f"smooth.{l}", outs[l], q=q) for l in range(n)]


# ------------------------------------------------------------------ heads
def _gap_concat(levels):
    """Levels along time with one zero column between neighbours, the
    validity mask (1, total, 1), and the indices of the real columns."""
    b, _, d = levels[0].shape
    parts, mask, real, off = [], [], [], 0
    for i, lvl in enumerate(levels):
        parts.append(lvl)
        mask.append(torch.ones(lvl.shape[1]))
        real.append(torch.arange(off, off + lvl.shape[1]))
        off += lvl.shape[1]
        if i + 1 < len(levels):
            parts.append(lvl.new_zeros((b, 1, d)))
            mask.append(torch.zeros(1))
            off += 1
    dev = levels[0].device
    return (torch.cat(parts, dim=1), torch.cat(mask).to(dev)[None, :, None],
            torch.cat(real).to(dev))


def heads(p: Params, dims, pyramid, q: Round = identity):
    """The two towers over the gap-padded concat of the levels, each conv
    block re-zeroed on the gaps, then k=3 output convs; distances
    exp(8·tanh(scale_l·raw/8))·stride_l. → (d_start, d_end, match) (B, N)."""
    x, mask, real = _gap_concat(pyramid)

    def tower(name, out):
        y = x
        for i in range(dims["head_tower_layers"]):
            y = block(p, f"{name}.{i}", y, q=q) * mask
        return conv1d(y, p[f"{out}.weight"], p[f"{out}.bias"], 1, q)[:, real]

    raw = tower("loc_tower", "loc_out")
    match = tower("match_tower", "match_out")[..., 0]
    sizes = [t.shape[1] for t in pyramid]
    dev = raw.device
    scale = torch.cat([p["scales"][l].expand(t) for l, t in enumerate(sizes)])
    stride = torch.cat([torch.full((t,), float(2 ** l), device=dev)
                        for l, t in enumerate(sizes)])
    d = torch.exp(8.0 * torch.tanh(scale[None, :, None] * raw / 8.0)) \
        * stride[None, :, None]
    return d[..., 0], d[..., 1], match


def locations(dims, device=None):
    """Cell centres (i + 0.5)·2**l of every level, level-major (N,), with
    each location's level (N,)."""
    locs, lids = [], []
    for l, t in enumerate(level_sizes(dims)):
        locs.append((torch.arange(t, dtype=torch.float32, device=device)
                     + 0.5) * float(2 ** l))
        lids.append(torch.full((t,), l, dtype=torch.long, device=device))
    return torch.cat(locs), torch.cat(lids)


def decode(dims, d_start, d_end, clip: bool = True):
    """(loc − d_start, loc + d_end), clipped to [0, T] when `clip`, end
    never before start → (B, N, 2)."""
    loc, _ = locations(dims, d_start.device)
    start, end = loc - d_start, loc + d_end
    if clip:
        t = float(dims["num_clips"])
        start, end = start.clamp(0.0, t), end.clamp(0.0, t)
    return torch.stack([start, torch.maximum(end, start)], dim=-1)


def _sample(feat, pos):
    """Linear interpolation of (B, T, D) at (B, N) positions, clipped to
    [0, T − 1]."""
    t, d = feat.shape[1], feat.shape[2]
    pos = pos.clamp(0.0, t - 1.0)
    lo = pos.floor()
    hi = (lo + 1.0).clamp(max=t - 1.0)
    w = (pos - lo)[..., None]
    take = lambda i: torch.gather(feat, 1, i.long()[..., None].expand(-1, -1, d))  # noqa: E731
    return take(lo) * (1.0 - w) + take(hi) * w


def iou_head(p: Params, dims, pyramid, segments, q: Round = identity):
    """Each location's level sampled at its segment's start, mid and end
    (grid positions p / stride − 0.5, kept inside the level), then k=1 conv
    blocks and a k=1 output conv → IoU logits (B, N)."""
    sizes = level_sizes(dims)
    cols, off = [], 0
    for l, (feat, t) in enumerate(zip(pyramid, sizes)):
        seg = segments[:, off:off + t]
        s = float(2 ** l)
        start, end = seg[..., 0], seg[..., 1]
        picks = [torch.clamp(x / s - 0.5, 0.0, t - 1.0)
                 for x in (start, 0.5 * (start + end), end)]
        cols.append(torch.cat([_sample(feat, x) for x in picks], dim=-1))
        off += t
    x = torch.cat(cols, dim=1)
    for i in range(dims["iou_head_layers"]):
        x = block(p, f"iou_mix.{i}", x, q=q)
    return conv1d(x, p["iou_out.weight"], p["iou_out.bias"], 1, q)[..., 0]


def forward(p: Params, dims, features, word_ids, query_mask,
            q: Round = identity) -> Dict[str, torch.Tensor]:
    """The whole model → d_start, d_end, match_logits, iou_logits (B, N) and
    segments (B, N, 2) in grid units. No gradient flows through the IoU
    head's sampling positions."""
    queries = query_encoder(p, dims, word_ids, query_mask, q)
    levels = backbone(p, dims, features, q)
    pyramid = fpn(p, dims, fusion(p, dims, levels, queries, q), q)
    d_start, d_end, match = heads(p, dims, pyramid, q)
    segments = decode(dims, d_start, d_end).detach()
    return {"d_start": d_start, "d_end": d_end, "match_logits": match,
            "iou_logits": iou_head(p, dims, pyramid, segments, q),
            "segments": segments}


PARTS: Sequence[str] = ("query_encoder", "backbone", "fusion", "fpn",
                        "heads", "iou_head")
