"""Hand-written CUDA kernels of the port (sm_90a), one module per TPU kernel.

Each wrapper launches its kernel for a CUDA tensor and calls its plain
PyTorch version for a CPU tensor, and counts its kernel launches in a plain
integer attribute (`wrapper.launches`), so a run can show that the main
path went through the kernels. Their gradients are in `autograd.py`.
The four package kernels launch through `torch.library` custom ops
(`torch.ops.drn_tpu_torch.conv_ln_relu`, `.fused_fusion_block`,
`.fused_fusion`, `.fused_stem`; CUDA only, each with a fake function that
gives its output's shape), and so do the backward epilogues of the first
two (`.conv_ln_relu_bwd`, `.fused_fusion_block_bwd`: the conv kernel's
backward mode, which `autograd.py` launches), so `torch.export` keeps
each launch as one opaque node (export.py); importing this package
registers them. The
checks, the launch plan, the count and the FLOPs run in the op's body,
when it runs. (`fused_fusion`, the wrapper, is reached through its module
of the same name: `drn_tpu_torch.ops.cuda.fused_fusion.fused_fusion`.)
`pallas_block` is the measurement probe's block (`drn_tpu_torch.probes`),
with its plain version and the probe's comparison `xla_block`; it never
lies in an exported graph and stays a direct ctypes launch, and so does
`map_epilogue`, 2D-TAN's map-conv epilogue (models/tan.py; no export
runs 2D-TAN), which counts beside its launches the map-conv output cells
it goes over (`map_epilogue.cells`; a DRN step reads 0 of both).
"""

from __future__ import annotations

from typing import Dict

from drn_tpu_torch.ops.cuda import fused_fusion as _fusion
from drn_tpu_torch.ops.cuda.block_probe import (pallas_block,
                                                pallas_block_reference,
                                                xla_block)
from drn_tpu_torch.ops.cuda.conv_block import conv_ln_relu, conv_ln_relu_bwd
from drn_tpu_torch.ops.cuda.fused_fusion import (fused_fusion_block,
                                                 fused_fusion_block_bwd)
from drn_tpu_torch.ops.cuda.map_epilogue import map_epilogue
from drn_tpu_torch.ops.cuda.stem import fused_stem

KERNELS = (fused_stem, fused_fusion_block, conv_ln_relu, _fusion.fused_fusion,
           pallas_block, conv_ln_relu_bwd, fused_fusion_block_bwd,
           map_epilogue)


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    map_epilogue.cells = 0
