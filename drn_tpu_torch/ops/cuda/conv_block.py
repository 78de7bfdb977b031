"""conv1d + bias + LayerNorm + ReLU in one kernel: the port of
`drn_tpu/ops/pallas/conv_block.py::conv_ln_relu`.

`conv_ln_relu` launches the CUDA kernel (csrc/conv_block.cu on
csrc/conv_sm90.cuh, built on first use) for a CUDA tensor, through the
custom op `torch.ops.drn_tpu_torch.conv_ln_relu` (`conv_ln_relu_op`), and
calls `conv_ln_relu_reference`, its plain PyTorch version, for a CPU
tensor. Nothing else chooses between them, and a CUDA tensor the kernel
does not take raises: there is no fallback.

The kernel owns 64 output rows and all Cout columns a block (wgmma, a TMA
weight ring, A gathered row by row). `conv_plan` decides what the C source
cannot see, the card's SM count: where the row tiles alone would leave
SMs idle, a cluster of 2 or 4 blocks shares each tile and splits its 512
columns. The entry point derives everything else (stages, shared memory)
itself and refuses a split or grid it does not build.

Layout as in the JAX package: activations (B, T, C) channels-last, weights
WIO (K, Cin, Cout). The kernel takes bf16 activations and weights and fp32
bias / scale / offset, accumulates in fp32 and adds the bias to the fp32
accumulator (the TPU kernel does the same; the JAX package's XLA path
rounds the conv output to bf16 before its bf16 bias add, which the bf16
tolerances of the tests absorb). The wrapper is forward only and refuses
an input that needs a gradient; the model reaches it through
`ops/cuda/autograd.py`.

`conv_ln_relu_bwd` is the block's backward where LayerNorm is on: the same
kernel with its backward epilogue (custom op
`torch.ops.drn_tpu_torch.conv_ln_relu_bwd`) recomputes the conv and takes
the LayerNorm+ReLU VJP (`ln_relu_vjp`, in closed form) at the fp32
accumulator: (dpre, dscale, doffset, db). `conv_ln_relu_bwd_reference` is
its plain version, with the same arithmetic.

The helpers below (`same_padding`, `layer_norm`, `conv_taps`,
`check_cuda_inputs`, `refuse_grad`, `check_cout`, `stream_of`, and
`conv_vjp`, the conv's VJP for the backward passes) are shared by the
other kernels' modules. Each op reports its conv's FLOPs where it
launches (`utils.flops.add_conv`): `estimate_flops` cannot see a ctypes
launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.utils import flops

LN_EPS = 1e-6  # flax.linen.LayerNorm default
KERNEL_COUTS = (64, 128, 256, 512)  # instantiated by every kernel source
TILE_ROWS = 64  # output rows of a conv_ln_relu block: one wgmma M
# Blocks that may share a row tile's columns, by Cout (csrc/conv_sm90.cuh
# builds these and refuses any other).
CONV_SPLITS = {64: (1,), 128: (1,), 256: (1,), 512: (1, 2, 4)}


def same_padding(t: int, k: int, stride: int) -> Tuple[int, int, int]:
    """XLA 'SAME' padding: (out_t, pad_left, pad_right), the remainder on
    the right (left 0 / right 1 for k=3, even T, stride 2)."""
    out_t = -(-t // stride)
    total = max((out_t - 1) * stride + k - t, 0)
    left = total // 2
    return out_t, left, total - left


def layer_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """flax.linen.LayerNorm over the last axis, in fp32: fast variance
    E[x²] − E[x]² clamped at 0, then (x − mean)·(rsqrt(var + eps)·scale)
    + offset. (torch's layer_norm takes the variance another way.)"""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * scale.float()) \
        + offset.float()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_inputs(name: str, **tensors: Tuple[torch.Tensor, torch.dtype,
                                                  tuple]) -> None:
    """Raise unless every tensor is on the first one's CUDA device, of the
    dtype and shape given (None in a shape matches any size), contiguous
    and 16-byte aligned."""
    dev = None
    for arg, (t, dtype, shape) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype} "
                            "(the kernel takes no other type)")
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def refuse_grad(name: str, **tensors: torch.Tensor) -> None:
    """Raise if grad is enabled and a tensor needs it: the kernels are
    forward only. The wrappers check this before their custom op, whose
    body runs with grad off."""
    if not torch.is_grad_enabled():
        return
    for arg, t in tensors.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad; the CUDA kernel is forward "
                "only (call it under torch.no_grad(), or through "
                "drn_tpu_torch.ops.cuda.autograd)")


def check_cout(name: str, cout: int) -> None:
    """The kernel template is instantiated for these output widths; it
    takes any input width."""
    if cout not in KERNEL_COUTS:
        raise ValueError(f"{name}: Cout={cout} not in {KERNEL_COUTS}")


class ConvPlan(NamedTuple):
    split: int  # blocks (a thread block cluster) sharing a row tile
    grid: int   # blocks: split * ceil(M / TILE_ROWS)


def conv_plan(m: int, cout: int, sms: int) -> ConvPlan:
    """Launch geometry of the conv_ln_relu kernel for M = B·T_out output
    rows on a card with `sms` SMs: the largest split of CONV_SPLITS[cout]
    whose blocks, split per row tile, all fit the SMs at once."""
    check_cout("conv_ln_relu", cout)
    tiles = -(-m // TILE_ROWS)
    split = max(s for s in CONV_SPLITS[cout] if s == 1 or s * tiles <= sms)
    return ConvPlan(split, split * tiles)


def conv_taps(x, w, out_t: int, left: int, stride: int = 1):
    """Σ_i x[t·stride − left + i] @ w[i] over the K taps, x zero outside
    [0, T): K shifted (B, out_t, Cin) @ (Cin, Cout) products accumulated in
    fp32 → (B, out_t, Cout) fp32."""
    k, t = w.shape[0], x.shape[1]
    span = (out_t - 1) * stride + 1
    xp = F.pad(x.float(), (0, 0, left, max(span + k - 1 - left - t, 0)))
    acc = None
    for i in range(k):
        y = xp[:, i:i + span:stride] @ w[i].float()
        acc = y if acc is None else acc + y
    return acc


def conv_ln_relu_reference(x, w, b, scale, offset, stride: int = 1,
                           use_norm: bool = True, use_act: bool = True):
    """Plain PyTorch version of the kernel, with its arithmetic: K shifted
    (B, T_out, Cin) @ (Cin, Cout) products accumulated in fp32 over
    SAME-padded taps, + b in fp32, optional flax LayerNorm in fp32,
    optional ReLU, output in x.dtype."""
    out_t, left, _ = same_padding(x.shape[1], w.shape[0], stride)
    acc = conv_taps(x, w, out_t, left, stride) + b.float()
    if use_norm:
        acc = layer_norm(acc, scale, offset)
    if use_act:
        acc = torch.relu(acc)
    return acc.to(x.dtype)


def ln_relu_vjp(pre: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                g: torch.Tensor, use_act: bool, eps: float = LN_EPS):
    """The VJP of relu?(layer_norm(pre, scale, offset)) at the fp32 rows
    `pre` (…, C) for the cotangent g, in closed form: (dpre fp32, dscale,
    doffset, db = dpre summed over the rows). With x̂ = (pre − mean)·rstd
    and gh = g·[y > 0 where use_act]·scale (y the forward's output before
    the ReLU, computed as `layer_norm` computes it),
    dpre = rstd·(gh − mean(gh) − x̂·mean(gh·x̂)), rounded as the kernel
    rounds it, rstd·gh − rstd·(mean(gh) + x̂·mean(gh·x̂)); the x̂ term is off
    where the fast variance clamps at 0 (its gradient through clamp_min)."""
    mean = pre.mean(-1, keepdim=True)
    var = (pre * pre).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    scale, offset = scale.float(), offset.float()
    d = pre - mean
    xhat = d * rstd
    g = g.float()
    if use_act:
        g = g * (d * (rstd * scale) + offset > 0)
    gh = g * scale
    mgx = (gh * xhat).mean(-1, keepdim=True) * (var >= 0)
    dpre = rstd * gh - rstd * (gh.mean(-1, keepdim=True) + xhat * mgx)
    rows = tuple(range(pre.dim() - 1))
    return dpre, (g * xhat).sum(rows), g.sum(rows), dpre.sum(rows)


def conv_ln_relu_bwd_reference(x, w, b, scale, offset, g, stride: int = 1,
                               use_act: bool = True):
    """Plain version of the backward kernel: the conv + b recomputed in
    fp32 (no rounding), then `ln_relu_vjp` for the output's cotangent g:
    (dpre in x.dtype, dscale, doffset, db in fp32)."""
    out_t, left, _ = same_padding(x.shape[1], w.shape[0], stride)
    pre = conv_taps(x, w, out_t, left, stride) + b.float()
    dpre, ds, do, db = ln_relu_vjp(pre, scale, offset, g, use_act)
    return dpre.to(x.dtype), ds, do, db


def conv_vjp(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, stride: int,
             need_dx: bool = True, need_dw: bool = True
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """VJP of the SAME conv y = conv1d(x, w, stride) (x (B, T, Cin), w WIO
    (K, Cin, Cout), y (B, T_out, Cout)) for dy in y's dtype: (dx, dw) in
    the dtypes of x and w. One matrix product per tap, fp32 accumulation:
    dw[i] = Σ x[t·s − left + i]ᵀ dy[t]; dx[t·s − left + i] += dy[t] w[i]ᵀ."""
    k, cin, cout = w.shape
    bsz, t, _ = x.shape
    out_t, left, right = same_padding(t, k, stride)
    span = (out_t - 1) * stride + 1
    dy2 = dy.reshape(-1, cout)
    dx = dw = None
    if need_dw:
        xp = F.pad(x, (0, 0, left, right))
        dw = torch.stack([xp[:, i:i + span:stride].reshape(-1, cin).t()
                          .matmul(dy2) for i in range(k)]).to(w.dtype)
    if need_dx:
        gx = torch.zeros((bsz, t + left + right, cin), dtype=torch.float32,
                         device=x.device)
        for i in range(k):
            gx[:, i:i + span:stride] += dy2.matmul(w[i].t()).reshape(
                bsz, out_t, cin).float()
        dx = gx[:, left:left + t].to(x.dtype)
    return dx, dw


def conv_ln_relu(x, w, b, scale, offset, stride: int = 1,
                 use_norm: bool = True, use_act: bool = True):
    """relu(LayerNorm(conv1d(x, w, SAME, stride) + b) · scale + offset).

    x: (B, T, Cin); w: (K, Cin, Cout) WIO; b/scale/offset: (Cout,).
    Output (B, ceil(T/stride), Cout) in x.dtype. On CUDA: x and w bf16,
    b/scale/offset fp32, Cout in KERNEL_COUTS; the launch is the custom op
    `torch.ops.drn_tpu_torch.conv_ln_relu`.
    """
    if x.device.type == "cpu":
        return conv_ln_relu_reference(x, w, b, scale, offset, stride,
                                      use_norm, use_act)
    refuse_grad("conv_ln_relu", x=x, w=w, b=b, scale=scale, offset=offset)
    return conv_ln_relu_op(x, w, b, scale, offset, stride, use_norm, use_act)


conv_ln_relu.launches = 0


def _check_conv(name, x, w, b, scale, offset, stride, **more):
    """Raise unless the kernel takes these inputs (and each `more`, a
    name → (tensor, dtype, shape)); → (B, T, Cin, Cout, K, T_out, left)."""
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    check_cout(name, cout)
    if stride < 1 or k < 1:
        raise ValueError(f"{name}: stride={stride}, K={k}")
    check_cuda_inputs(
        name,
        x=(x, torch.bfloat16, (None, None, cin)),
        w=(w, torch.bfloat16, (k, cin, cout)),
        b=(b, torch.float32, (cout,)),
        scale=(scale, torch.float32, (cout,)),
        offset=(offset, torch.float32, (cout,)),
        **more,
    )
    return (bsz, t, cin, cout, k, *same_padding(t, k, stride)[:2])


@torch.library.custom_op("drn_tpu_torch::conv_ln_relu", mutates_args=(),
                         device_types="cuda")
def conv_ln_relu_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    scale: torch.Tensor, offset: torch.Tensor, stride: int,
                    use_norm: bool, use_act: bool) -> torch.Tensor:
    """The kernel's launch: checks, `conv_plan`, the launch, its count and
    its FLOPs, all when the op runs (an exported graph holds the op)."""
    bsz, t, cin, cout, k, out_t, left = _check_conv(
        "conv_ln_relu", x, w, b, scale, offset, stride)
    plan = conv_plan(bsz * out_t, cout, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    out = torch.empty((bsz, out_t, cout), dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.entry("conv_block", "drn_conv_ln_relu", 6, 12)
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), out.data_ptr(), bsz, t, cin, cout, k, stride,
            out_t, left, int(use_norm), int(use_act), *plan, stream_of(x))
    if rc != 0:
        raise RuntimeError(f"conv_ln_relu: CUDA error {rc} at launch")
    conv_ln_relu.launches += 1
    flops.add_conv(bsz, out_t, cin, cout, k)
    return out


@conv_ln_relu_op.register_fake
def _(x, w, b, scale, offset, stride, use_norm, use_act):
    out_t = same_padding(x.shape[1], w.shape[0], stride)[0]
    return x.new_empty((x.shape[0], out_t, w.shape[2]), dtype=torch.bfloat16)


def conv_ln_relu_bwd(x, w, b, scale, offset, g, stride: int = 1,
                     use_act: bool = True):
    """The backward of conv_ln_relu with LayerNorm on, for its output's
    cotangent g (B, T_out, Cout): (dpre (B, T_out, Cout) in x.dtype, the
    VJP at the recomputed fp32 conv + b; dscale, doffset, db (Cout,) fp32).
    On CUDA: the inputs as `conv_ln_relu` takes them, g bf16; the launch is
    the custom op `torch.ops.drn_tpu_torch.conv_ln_relu_bwd`."""
    if x.device.type == "cpu":
        return conv_ln_relu_bwd_reference(x, w, b, scale, offset, g, stride,
                                          use_act)
    refuse_grad("conv_ln_relu_bwd", x=x, w=w, b=b, scale=scale,
                offset=offset, g=g)
    return conv_ln_relu_bwd_op(x, w, b, scale, offset, g, stride, use_act)


conv_ln_relu_bwd.launches = 0


def bwd_outputs(g: torch.Tensor):
    """The backward kernels' outputs for the cotangent g (B, T, Cout):
    dpre like g; the tiles' column partials (tiles, 3, Cout), dscale,
    doffset, db (Cout,) fp32. tiles = ceil(B·T / TILE_ROWS): one block a
    row tile, the grid."""
    bsz, t, cout = g.shape
    f32 = dict(dtype=torch.float32, device=g.device)
    return (torch.empty_like(g), torch.empty((-(-bsz * t // TILE_ROWS), 3,
                                              cout), **f32),
            *(torch.empty(cout, **f32) for _ in range(3)))


@torch.library.custom_op("drn_tpu_torch::conv_ln_relu_bwd", mutates_args=(),
                         device_types="cuda")
def conv_ln_relu_bwd_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        scale: torch.Tensor, offset: torch.Tensor,
                        g: torch.Tensor, stride: int, use_act: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """The backward kernel's launch (one block a row tile) and the tiles'
    column sums, its count and its FLOPs (the recompute's conv, as the
    forward launch counts it)."""
    bsz, t, cin, cout, k, out_t, left = _check_conv(
        "conv_ln_relu_bwd", x, w, b, scale, offset, stride,
        g=(g, torch.bfloat16, (x.shape[0], None, w.shape[2])))
    if g.shape[1] != out_t:
        raise ValueError(f"conv_ln_relu_bwd: g has {g.shape[1]} rows a "
                         f"video, expected {out_t}")
    dpre, part, ds, do, db = bwd_outputs(g)
    fn = _build.entry("conv_block", "drn_conv_ln_relu_bwd", 11, 10)
    rc = fn(*(a.data_ptr() for a in (x, w, b, scale, offset, g, dpre, part,
                                     ds, do, db)),
            bsz, t, cin, cout, k, stride, out_t, left, int(use_act),
            part.shape[0], stream_of(x))
    if rc != 0:
        raise RuntimeError(f"conv_ln_relu_bwd: CUDA error {rc} at launch")
    conv_ln_relu_bwd.launches += 1
    flops.add_conv(bsz, out_t, cin, cout, k)
    return dpre, ds, do, db


@conv_ln_relu_bwd_op.register_fake
def _(x, w, b, scale, offset, g, stride, use_act):
    cout = w.shape[2]
    return (torch.empty_like(g, dtype=torch.bfloat16),
            *(g.new_empty(cout, dtype=torch.float32) for _ in range(3)))
