"""The precision control: the reference computed one step below the
configuration's compute type.

The configurations state bfloat16 compute, so the control computes every
matrix product of the reference on fp8 (e4m3) operands: each operand is
scaled by its largest magnitude onto the format's range (448), rounded to
fp8 and scaled back, and the product accumulates in fp32, as an fp8 GEMM
with per-tensor scales does. Gradients pass the rounding unchanged (the
straight-through rule), so the training control follows the same steps.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x.detach())


ROUNDINGS = {"fp8": fp8}
