"""The backbone stem in one kernel: the port of
`drn_tpu/ops/pallas/stem.py::fused_stem`.

input LayerNorm over Cin (fp32) → cast to bf16 → conv1d Cin→Cout (K odd)
→ bias → LayerNorm (fp32) → ReLU. The CUDA kernel (csrc/stem.cu) keeps the
normalised copy of the features out of HBM: a first small pass writes each
row's mean and rstd, and the conv kernel normalises each fp32 chunk as it
stages it. A CUDA tensor launches the kernel or raises; a CPU tensor takes
`fused_stem_reference`. The output LayerNorm and ReLU can be turned off
(`use_norm`, `use_act`): the backward pass (ops/cuda/autograd.py)
recomputes the pre-LayerNorm conv that way.
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import (check_cout, check_cuda_inputs,
                                               conv_ln_relu_reference,
                                               layer_norm, stream_of)
from drn_tpu_torch.utils import flops


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

    x: (B, T, Cin) fp32 features, any Cin; w: (K, Cin, Cout) WIO, K odd.
    Output (B, T, Cout) in `cdtype`. On CUDA: cdtype and w bf16, every
    other input fp32.
    """
    if x.device.type == "cpu":
        return fused_stem_reference(x, in_scale, in_bias, w, b, out_scale,
                                    out_bias, cdtype, use_norm, use_act)
    bsz, t, cin = x.shape
    k, _, cout = w.shape
    if k % 2 == 0:
        raise ValueError(f"fused_stem: odd kernel width needed, got {k}")
    if cdtype != torch.bfloat16:
        raise TypeError(f"fused_stem: the kernel computes in bf16, got {cdtype}")
    check_cout("fused_stem", cout)
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
    fn = _build.entry("stem", "drn_fused_stem", 9, 7)
    rc = fn(x.data_ptr(), in_scale.data_ptr(), in_bias.data_ptr(),
            w.data_ptr(), b.data_ptr(), out_scale.data_ptr(),
            out_bias.data_ptr(), stats.data_ptr(), out.data_ptr(), bsz, t,
            cin, cout, k, int(use_norm), int(use_act), stream_of(x))
    if rc != 0:
        raise RuntimeError(f"fused_stem: CUDA error {rc} at launch")
    fused_stem.launches += 1
    flops.add_conv(bsz, t, cin, cout, k)
    return out


fused_stem.launches = 0
