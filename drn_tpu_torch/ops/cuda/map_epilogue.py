"""The epilogue of 2D-TAN's map convs (models/tan.py): bias, ReLU and the
count weights of the mask in one pass over the conv's output, in place.

    y ← relu(y + bias) · w     y (B, H, W, C), bias (C,), w (H, W)

A CUDA tensor (bf16, contiguous as (B, H, W, C): the channels-last output
of the conv) launches csrc/map_epilogue.cu; a CPU tensor takes
`map_epilogue_reference`, the plain version, with the same arithmetic:
fp32 sum, ReLU and product, one rounding to y's dtype.

Two counters, reset by `drn_tpu_torch.ops.cuda.reset_launch_counts()`:
`map_epilogue.launches` (kernel launches, in `launch_counts()`) and
`map_epilogue.cells`, the map-conv output cells the epilogue went over,
which are the cells the convs computed (B·H·W a layer, on either device).
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import stream_of

BLOCKS_PER_SM = 16  # grid of the grid-stride loop: SMs × this, at most


def map_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    out = (y.float() + bias.float()).clamp_min(0.0) * w.float()[..., None]
    return y.copy_(out)


def map_epilogue(y: torch.Tensor, bias: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """y (B, H, W, C) in place; returns y."""
    b, h, wd, c = y.shape
    map_epilogue.cells += b * h * wd
    if y.device.type == "cpu":
        return map_epilogue_reference(y, bias, w)
    if y.dtype != torch.bfloat16 or not y.is_contiguous() or c % 8 \
            or y.data_ptr() % 16:
        raise ValueError(f"map_epilogue: y must be bf16, contiguous as (B, "
                         f"H, W, C) with C a multiple of 8, 16-byte aligned; "
                         f"got {y.dtype}, shape {tuple(y.shape)}, strides "
                         f"{y.stride()}")
    if bias.dtype != torch.float32 or bias.shape != (c,) \
            or w.dtype != torch.float32 or w.shape != (h, wd) \
            or not w.is_contiguous() or not bias.is_contiguous() \
            or bias.device != y.device or w.device != y.device:
        raise ValueError("map_epilogue: bias (C,) and w (H, W) must be fp32, "
                         "contiguous, on y's device")
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    vecs = b * h * wd * (c // 8)
    grid = max(1, min(-(-vecs // 256), sms * BLOCKS_PER_SM))
    fn = _build.entry("map_epilogue", "drn_map_epilogue", 3, 4)
    rc = fn(y.data_ptr(), bias.data_ptr(), w.data_ptr(), b * h * wd, c,
            h * wd, grid, stream_of(y))
    if rc != 0:
        raise RuntimeError(f"map_epilogue: CUDA error {rc} at launch")
    map_epilogue.launches += 1
    return y


map_epilogue.launches = 0
map_epilogue.cells = 0
