"""Hand-written CUDA kernels of the port (sm_90a), one module per TPU kernel.

Each wrapper launches its kernel for a CUDA tensor and calls its plain
PyTorch version for a CPU tensor, and counts its kernel launches in a plain
integer attribute (`wrapper.launches`), so a run can show that the main
path went through the kernels. Their gradients are in `autograd.py`.
(`fused_fusion`, the wrapper, is reached through its module of the same
name: `drn_tpu_torch.ops.cuda.fused_fusion.fused_fusion`.) `pallas_block`
is the measurement probe's block (`drn_tpu_torch.probes`), with its plain
version and the probe's comparison `xla_block`.
"""

from __future__ import annotations

from typing import Dict

from drn_tpu_torch.ops.cuda import fused_fusion as _fusion
from drn_tpu_torch.ops.cuda.block_probe import (pallas_block,
                                                pallas_block_reference,
                                                xla_block)
from drn_tpu_torch.ops.cuda.conv_block import conv_ln_relu
from drn_tpu_torch.ops.cuda.fused_fusion import fused_fusion_block
from drn_tpu_torch.ops.cuda.stem import fused_stem

KERNELS = (fused_stem, fused_fusion_block, conv_ln_relu, _fusion.fused_fusion,
           pallas_block)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
