"""The backbone stem in one kernel: the port of
`drn_tpu/ops/pallas/stem.py::fused_stem`.

input LayerNorm over Cin (fp32) → cast to bf16 → conv1d Cin→Cout (K odd)
→ bias → LayerNorm (fp32) → ReLU. The CUDA kernel (csrc/stem.cu,
csrc/stem_sm90.cuh) keeps the normalised copy of the features out of HBM:
a first small pass writes each row's mean and rstd, and the conv kernel
normalises each fp32 chunk as it stages it for the tensor cores (wgmma,
64-row tiles of all Cout columns). A CUDA tensor launches the kernel or
raises; a CPU tensor takes `fused_stem_reference`. The output LayerNorm
and ReLU can be turned off (`use_norm`, `use_act`): the backward pass
(ops/cuda/autograd.py) recomputes the pre-LayerNorm conv that way.

`stem_plan` is the kernel's launch geometry, computed here and checked by
the C entry point against what the source instantiates. Where the 64-row
tiles alone would leave half the SMs idle (the eval step's B=48: 48 tiles
on 132 SMs), two blocks, a thread block cluster, share each tile and
split its 512 Cout columns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import (check_cuda_inputs,
                                               conv_ln_relu_reference,
                                               layer_norm, refuse_grad,
                                               stream_of)
from drn_tpu_torch.utils import flops

# csrc/stem_sm90.cuh: the widths it instantiates, its tile, its ring.
STEM_COUTS = (64, 128, 256, 512)
TILE_ROWS = 64   # output rows of a block: one wgmma M
TILE_DEPTH = 64  # channels of a k-tile: one 128-byte swizzle row of bf16
MAX_STAGES = 8
MAX_K = 17       # a producer thread holds the (rows + K - 1)-row window
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on an H100
# LayerNorm row sums of up to four warpgroups, barriers, the ring's
# alignment (kFixedBytes).
SMEM_FIXED = 4 * TILE_ROWS * 8 + 2 * MAX_STAGES * 8 + 1024
H100_SMS = 132


class StemPlan(NamedTuple):
    rows: int        # output rows per block
    depth: int       # channels per k-tile
    split: int       # blocks (a cluster) sharing a row tile's Cout columns
    stages: int      # k-tiles in the shared-memory ring
    smem_bytes: int  # dynamic shared memory per block
    grid: int        # blocks: split * ceil(M / rows)


def stem_plan(m: int, cin: int, cout: int, k: int = 3,
              sms: int = H100_SMS, split: Optional[int] = None) -> StemPlan:
    """Launch geometry of the stem kernel for M = B·T rows on a card with
    `sms` SMs. At Cout 512 the columns of a row tile are split over two
    blocks when twice the tiles still fit the SMs (on an H100 that was
    faster at the eval step's B=48, and slower at Cout 128). Each ring
    stage holds one A tile (rows × depth bf16) and one B tile (depth ×
    the block's columns, bf16); as many stages as fit, at most
    MAX_STAGES. `split` forces the split (a probe's choice; None takes
    the rule above): 1, or 2 at Cout 512, the one width the source
    builds split."""
    if cout not in STEM_COUTS:
        raise ValueError(f"fused_stem: Cout={cout} not in {STEM_COUTS}")
    if k % 2 == 0 or k > MAX_K:
        raise ValueError(f"fused_stem: K={k}; the kernel takes odd K up to "
                         f"{MAX_K}")
    tiles = -(-m // TILE_ROWS)
    if split is None:
        split = 2 if cout == 512 and 2 * tiles <= sms else 1
    elif split not in (1, 2) or (split == 2 and cout != 512):
        raise ValueError(f"fused_stem: split={split} at Cout={cout}; the "
                         "kernel is built for split 1, and 2 at Cout 512")
    stage = 2 * TILE_DEPTH * (TILE_ROWS + cout // split)
    stages = min(MAX_STAGES, (SMEM_LIMIT - SMEM_FIXED) // stage)
    return StemPlan(TILE_ROWS, TILE_DEPTH, split, stages,
                    stages * stage + SMEM_FIXED, split * tiles)


def fused_stem_reference(x, in_scale, in_bias, w, b, out_scale, out_bias,
                         cdtype=torch.bfloat16, use_norm: bool = True,
                         use_act: bool = True):
    """Plain version: flax input LN in fp32, cast to `cdtype`, then the
    conv block's plain version with the weight in `cdtype`."""
    xn = layer_norm(x.float(), in_scale, in_bias).to(cdtype)
    return conv_ln_relu_reference(xn, w.to(cdtype), b, out_scale, out_bias,
                                  1, use_norm, use_act)


def fused_stem(x, in_scale, in_bias, w, b, out_scale, out_bias,
               cdtype=torch.bfloat16, use_norm: bool = True,
               use_act: bool = True):
    """relu(LN(conv1d(LN(x)·s_in + b_in, w, SAME) + b)·s_out + b_out).

    x: (B, T, Cin) fp32 features, any Cin; w: (K, Cin, Cout) WIO, K odd
    (up to MAX_K on CUDA).
    Output (B, T, Cout) in `cdtype`. On CUDA: cdtype and w bf16, every
    other input fp32; the launch is the custom op
    `torch.ops.drn_tpu_torch.fused_stem`.
    """
    if x.device.type == "cpu":
        return fused_stem_reference(x, in_scale, in_bias, w, b, out_scale,
                                    out_bias, cdtype, use_norm, use_act)
    if cdtype != torch.bfloat16:
        raise TypeError(f"fused_stem: the kernel computes in bf16, got {cdtype}")
    refuse_grad("fused_stem", x=x, in_scale=in_scale, in_bias=in_bias, w=w,
                b=b, out_scale=out_scale, out_bias=out_bias)
    return fused_stem_op(x, in_scale, in_bias, w, b, out_scale, out_bias,
                         use_norm, use_act)


fused_stem.launches = 0


@torch.library.custom_op("drn_tpu_torch::fused_stem", mutates_args=(),
                         device_types="cuda")
def fused_stem_op(x: torch.Tensor, in_scale: torch.Tensor,
                  in_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  out_scale: torch.Tensor, out_bias: torch.Tensor,
                  use_norm: bool, use_act: bool) -> torch.Tensor:
    """The kernel's launch on `stem_plan`'s geometry, when the op runs."""
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    plan = stem_plan(bsz * t, cin, cout, k, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    return launch_stem(x, in_scale, in_bias, w, b, out_scale, out_bias,
                       use_norm, use_act, plan)


def launch_stem(x, in_scale, in_bias, w, b, out_scale, out_bias,
                use_norm: bool, use_act: bool, plan: StemPlan):
    """Checks, the statistics buffer, the launch on `plan`, its count and
    its FLOPs. The custom op's body, on `stem_plan`'s own plan; a probe
    passes a plan with a forced split (`probes/stem_probe.py`)."""
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    if k % 2 == 0:
        raise ValueError(f"fused_stem: odd kernel width needed, got {k}")
    check_cuda_inputs(
        "fused_stem",
        x=(x, torch.float32, (None, None, cin)),
        in_scale=(in_scale, torch.float32, (cin,)),
        in_bias=(in_bias, torch.float32, (cin,)),
        w=(w, torch.bfloat16, (k, cin, cout)),
        b=(b, torch.float32, (cout,)),
        out_scale=(out_scale, torch.float32, (cout,)),
        out_bias=(out_bias, torch.float32, (cout,)),
    )
    stats = torch.empty((bsz * t, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((bsz, t, cout), dtype=torch.bfloat16, device=x.device)
    fn = _build.entry("stem", "drn_fused_stem", 9, 13)
    rc = fn(x.data_ptr(), in_scale.data_ptr(), in_bias.data_ptr(),
            w.data_ptr(), b.data_ptr(), out_scale.data_ptr(),
            out_bias.data_ptr(), stats.data_ptr(), out.data_ptr(), bsz, t,
            cin, cout, k, int(use_norm), int(use_act), *plan,
            stream_of(x))
    if rc != 0:
        raise RuntimeError(f"fused_stem: CUDA error {rc} at launch")
    fused_stem.launches += 1
    flops.add_conv(bsz, t, cin, cout, k)
    return out


@fused_stem_op.register_fake
def _(x, in_scale, in_bias, w, b, out_scale, out_bias, use_norm, use_act):
    return x.new_empty((*x.shape[:2], w.shape[2]), dtype=torch.bfloat16)
