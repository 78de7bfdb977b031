"""The layers' collectives over one axis of the mesh, as autograd Functions
with their backward stated (the counterparts of what XLA's SPMD
partitioner inserts for the JAX package's model and time axes).

Every rank of an axis runs the same program on its own block. Downstream
of a gather every rank of the axis computes the same loss, so the
gradient a gather receives is whole and the same on every rank: its
backward takes this rank's slice (a reduce-scatter would count it axis
times). Upstream of a split computation the gradient each rank holds is
its block's share: `sum_grad` adds the shares up.

    gather_channels(x, g)  all-gather the last dim;  backward: slice
    gather_time(x, g)      all-gather dim 1;         backward: slice
    split_channels(x, g)   this rank's slice;        backward: all-gather
    sum_grad(x, g)         identity;                 backward: all-reduce
    sum_over(x, g)         all-reduce;               backward: all-reduce
    halo(x, l, r, g)       dim 1 extended by l rows of the left and r of
                           the right neighbour (zeros at the ends);
                           backward: those rows' gradients sent back

`group` None is an axis of one rank: every function is then the identity
(`halo` pads zeros). `halo` is built on `all_gather` of each block's
edge rows, so it needs no point-to-point and works the same under NCCL
and gloo.

Gloo's collectives are the host's: under gloo (the CPU tests, and two
ranks sharing one card, which NCCL refuses) a CUDA tensor is copied to
the host, exchanged and copied back (`_host`). That is the transport of
the communication, not a compute fallback: every computation stays on
the card.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _host(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (same shape), in group-rank order."""
    src = t.contiguous()
    if _host(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    if _host(group, out):
        host = out.cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    dist.all_reduce(out, group=group)
    return out


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g, ctx.group), dim=ctx.dim), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """(..., C/n) blocks → (..., C), rank order along the last dim."""
    return x if group is None else _Gather.apply(x, x.dim() - 1, group)


def gather_time(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T/n, ...) blocks → (B, T, ...)."""
    return x if group is None else _Gather.apply(x, 1, group)


def split_channels(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the last dim (a replicated parameter read by
    one channel block): the gradient blocks are gathered back whole."""
    return x if group is None else _Split.apply(x, x.dim() - 1, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself, whose gradient is the sum of the ranks' shares: a
    whole, replicated input to a computation each rank does a block of."""
    return x if group is None else _SumGrad.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks (row sums of a channel-split LayerNorm)."""
    return x if group is None else _SumOver.apply(x, group)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, group):
        ctx.left, ctx.right, ctx.group = left, right, group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        length = x.shape[1]
        if max(left, right) > length:
            raise ValueError(f"halo of {left}/{right} rows from blocks of "
                             f"{length}")
        # Each block's first `right` rows (its left neighbour's right
        # halo) and last `left` rows (its right neighbour's left halo).
        edges = _gather(torch.cat([x[:, :right], x[:, length - left:]], 1),
                        group)
        zeros = lambda k: x.new_zeros((x.shape[0], k, *x.shape[2:]))  # noqa
        lo = edges[r - 1][:, right:] if r > 0 else zeros(left)
        hi = edges[r + 1][:, :right] if r + 1 < n else zeros(right)
        return torch.cat([lo, x, hi], 1)

    @staticmethod
    def backward(ctx, g):
        left, right, group = ctx.left, ctx.right, ctx.group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        length = g.shape[1] - left - right
        dx = g[:, left:left + length].clone()
        sent = _gather(torch.cat([g[:, :left], g[:, left + length:]], 1),
                       group)
        if r + 1 < n:  # my last rows were my right neighbour's left halo
            dx[:, length - left:] += sent[r + 1][:, :left]
        if r > 0:      # my first rows were my left neighbour's right halo
            dx[:, :right] += sent[r - 1][:, left:]
        return dx, None, None, None


def halo(x: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """(B, L, ...) → (B, left + L + right, ...): the block with `left`
    rows of its left neighbour before it and `right` rows of its right
    neighbour after it, zeros beyond the clip axis's ends (SAME
    padding's zeros)."""
    if group is None:
        zeros = lambda k: x.new_zeros((x.shape[0], k, *x.shape[2:]))  # noqa
        return torch.cat([zeros(left), x, zeros(right)], 1)
    return _Halo.apply(x, left, right, group)


def axis_size(group: Optional[object]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def axis_rank(group: Optional[object]) -> int:
    return 0 if group is None else dist.get_rank(group)
