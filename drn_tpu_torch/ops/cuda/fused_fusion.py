"""Cross-modal fusion block in one kernel: the port of
`drn_tpu/ops/pallas/fused_fusion.py::fused_fusion_block`.

relu(LN(conv1d(v ⊙ q[:, None, :], w, SAME) + b) · scale + offset). The
CUDA kernel (csrc/fused_fusion.cu) forms the Hadamard product while it
stages a tile of v, so v ⊙ q never reaches HBM. A CUDA tensor launches the
kernel or raises; a CPU tensor takes `fused_fusion_block_reference`.
Forward only. (`fused_fusion`, the conv-only variant with a hand-written
backward, is off the eval path and is ported with training.)
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import (check_cuda_inputs,
                                               check_widths,
                                               conv_ln_relu_reference,
                                               stream_of)


def fused_fusion_block_reference(v, q, w, b, scale, offset):
    """Plain version: the product in v's dtype (one rounding, as the
    kernel and the JAX package), then the conv block's plain version."""
    x = v * q[:, None, :].to(v.dtype)
    return conv_ln_relu_reference(x, w, b, scale, offset, 1, True, True)


def fused_fusion_block(v, q, w, b, scale, offset):
    """v: (B, T, D); q: (B, D); w: (K, D, Dout) WIO, K odd;
    b/scale/offset: (Dout,). Output (B, T, Dout) in v.dtype. On CUDA:
    v, q, w bf16; b, scale, offset fp32."""
    if v.device.type == "cpu":
        return fused_fusion_block_reference(v, q, w, b, scale, offset)
    bsz, t, d = v.shape
    k, _, dout = w.shape
    if k % 2 == 0:
        raise ValueError(f"fused_fusion_block: odd kernel width needed, got {k}")
    check_widths("fused_fusion_block", d, dout)
    check_cuda_inputs(
        "fused_fusion_block",
        v=(v, torch.bfloat16, (None, None, d)),
        q=(q, torch.bfloat16, (bsz, d)),
        w=(w, torch.bfloat16, (k, d, dout)),
        b=(b, torch.float32, (dout,)),
        scale=(scale, torch.float32, (dout,)),
        offset=(offset, torch.float32, (dout,)),
    )
    out = torch.empty((bsz, t, dout), dtype=torch.bfloat16, device=v.device)
    fn = _build.entry("fused_fusion", "drn_fused_fusion_block", 7, 5)
    rc = fn(v.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), out.data_ptr(), bsz, t, d,
            dout, k, stream_of(v))
    if rc != 0:
        raise RuntimeError(f"fused_fusion_block: CUDA error {rc} at launch")
    fused_fusion_block.launches += 1
    return out


fused_fusion_block.launches = 0
