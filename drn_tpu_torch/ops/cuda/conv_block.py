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
`ops/cuda/autograd.py`, whose backward recomputes through it.

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


@torch.library.custom_op("drn_tpu_torch::conv_ln_relu", mutates_args=(),
                         device_types="cuda")
def conv_ln_relu_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    scale: torch.Tensor, offset: torch.Tensor, stride: int,
                    use_norm: bool, use_act: bool) -> torch.Tensor:
    """The kernel's launch: checks, `conv_plan`, the launch, its count and
    its FLOPs, all when the op runs (an exported graph holds the op)."""
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    check_cout("conv_ln_relu", cout)
    if stride < 1 or k < 1:
        raise ValueError(f"conv_ln_relu: stride={stride}, K={k}")
    check_cuda_inputs(
        "conv_ln_relu",
        x=(x, torch.bfloat16, (None, None, cin)),
        w=(w, torch.bfloat16, (k, cin, cout)),
        b=(b, torch.float32, (cout,)),
        scale=(scale, torch.float32, (cout,)),
        offset=(offset, torch.float32, (cout,)),
    )
    out_t, left, _ = same_padding(t, k, stride)
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
