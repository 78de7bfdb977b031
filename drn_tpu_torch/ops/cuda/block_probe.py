"""The measurement probe's fused fusion block: the port of
`scripts/pallas_block_probe.py::pallas_block` and its comparison
`::xla_block`.

`pallas_block`: relu(LN(conv1d(v ⊙ q[:, None, :], w) + b) · scale +
offset) in one kernel: csrc/block_probe.cu launches the Hadamard variant of
the conv block's kernel (csrc/conv_sm90.cuh), as the package's fusion
block (`fused_fusion.fused_fusion_block`) does, on the same launch
geometry, `conv_plan(B·T, Dout, SMs)`, under the probe's own contract:

  * b is bf16, widened to fp32 before it is added to the fp32 accumulator;
  * the LayerNorm's eps is an argument;
  * the input is padded with K // 2 zero rows on the left for any K up to
    MAX_K, odd or even (output row t reads rows t − K//2 + i): XLA's SAME
    for odd K, one row further left than SAME for even K.

The probe's `bb` argument is not carried over: it is the TPU kernel's batch
block, the rows of B that one grid step holds in VMEM. Its grid is B // bb,
so when B is not a multiple of bb the probe never writes the last B % bb
rows of its output. The CUDA kernel tiles the flattened (b, t) rows itself
and computes every batch row.

A CUDA tensor launches the kernel or raises; a CPU tensor takes
`pallas_block_reference`, the plain version. `xla_block` is the port of
the probe's comparison, which adds the bias in bf16 to the conv output
already rounded to bf16 (the kernel adds it in fp32): the two differ by
bf16 rounding flips. The port calls it only as the probe's yardstick.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import (LN_EPS, check_cout,
                                               check_cuda_inputs, conv_plan,
                                               conv_taps, layer_norm,
                                               refuse_grad, same_padding,
                                               stream_of)
from drn_tpu_torch.ops.cuda.fused_fusion import MAX_K
from drn_tpu_torch.utils import flops


def pallas_block_reference(v, q, w, b, scale, offset, eps: float = LN_EPS):
    """Plain version, the kernel's arithmetic: the product in v's dtype (one
    rounding), K shifted products accumulated in fp32 with K // 2 rows of
    left padding, + b widened to fp32, the fp32 LayerNorm with `eps`, ReLU,
    one rounding to v's dtype."""
    k, t = w.shape[0], v.shape[1]
    x = v * q[:, None, :].to(v.dtype)
    acc = conv_taps(x, w, t, k // 2) + b.float()
    return torch.relu(layer_norm(acc, scale, offset, eps)).to(v.dtype)


def xla_block(v, q, w, b, scale, offset, eps: float = LN_EPS):
    """The probe's `xla_block`: conv1d(v ⊙ q, w, SAME) rounded to v's dtype,
    + b in that dtype, then LayerNorm (E[x²] − E[x]², unclamped) in fp32,
    · scale + offset, ReLU, output in v's dtype."""
    k, t = w.shape[0], v.shape[1]
    x = v * q[:, None, :].to(v.dtype)
    _, left, _ = same_padding(t, k, 1)
    out = (conv_taps(x, w, t, left).to(v.dtype) + b.to(v.dtype)).float()
    mean = out.mean(-1, keepdim=True)
    var = (out * out).mean(-1, keepdim=True) - mean * mean
    y = (out - mean) * torch.rsqrt(var + eps) * scale.float() + offset.float()
    return F.relu(y).to(v.dtype)


def pallas_block(v, q, w, b, scale, offset, eps: float = LN_EPS):
    """v: (B, T, D); q: (B, D); w: (K, D, Dout) WIO, any K; b/scale/offset:
    (Dout,). Output (B, T, Dout) in v.dtype. On CUDA: v, q, w and b bf16,
    scale and offset fp32, Dout in KERNEL_COUTS, K up to MAX_K."""
    if v.device.type == "cpu":
        return pallas_block_reference(v, q, w, b, scale, offset, eps)
    bsz, t, d = v.shape
    k, _, dout = w.shape
    if k > MAX_K:
        raise ValueError(f"pallas_block: K={k}; the kernel takes K up to "
                         f"{MAX_K}")
    check_cout("pallas_block", dout)
    refuse_grad("pallas_block", v=v, q=q, w=w, b=b, scale=scale,
                offset=offset)
    check_cuda_inputs(
        "pallas_block",
        v=(v, torch.bfloat16, (None, None, d)),
        q=(q, torch.bfloat16, (bsz, d)),
        w=(w, torch.bfloat16, (k, d, dout)),
        b=(b, torch.bfloat16, (dout,)),
        scale=(scale, torch.float32, (dout,)),
        offset=(offset, torch.float32, (dout,)),
    )
    plan = conv_plan(bsz * t, dout, torch.cuda.get_device_properties(
        v.device).multi_processor_count)
    out = torch.empty((bsz, t, dout), dtype=torch.bfloat16, device=v.device)
    fn = _build.entry("block_probe", "drn_pallas_block", 7, 7, 1)
    rc = fn(v.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), out.data_ptr(), bsz, t, d,
            dout, k, *plan, eps, stream_of(v))
    if rc != 0:
        raise RuntimeError(f"pallas_block: CUDA error {rc} at launch")
    pallas_block.launches += 1
    flops.add_conv(bsz, t, d, dout, k)
    return out


pallas_block.launches = 0
