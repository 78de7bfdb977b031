"""The greedy suppression sweep of the eval step's temporal NMS
(ops/nms.py::batched_temporal_nms), on candidates already in rank order:

    keep[b, j] = no i < j with keep[b, i] and IoU(segs[b, i], segs[b, j]) > thr

A CUDA tensor (fp32, contiguous as (B, K, 2), K ≤ MAX_K) launches
csrc/nms_sweep.cu, one thread block a query, through the custom op
`torch.ops.drn_tpu_torch.nms_sweep` (so `torch.export` keeps the launch as
one node, export.py); a CPU tensor takes `nms_sweep_reference`, the plain
version: the K-step masked sweep over the (B, K, K) IoU matrix of
`ops/temporal.py::temporal_iou`, whose fp32 operations the kernel repeats
in the same order. The two keep masks are equal bit for bit.

Two counters, reset by `drn_tpu_torch.ops.cuda.reset_launch_counts()`:
`nms_sweep.launches` (kernel launches, in `launch_counts()`) and
`nms_sweep.candidates`, the candidates swept (B·K a call, on either
device).
"""

from __future__ import annotations

import torch

from drn_tpu_torch.ops.cuda import _build
from drn_tpu_torch.ops.cuda.conv_block import stream_of
from drn_tpu_torch.ops.temporal import temporal_iou

MAX_K = 16384  # a block's shared memory: 8·K bytes of segments, K/8 of mask
MAX_THREADS = 1024


def sweep_threads(k: int) -> int:
    """The block size for K candidates: a thread a candidate, in whole
    warps, at most MAX_THREADS (at B=128, K=2,548 on the H100 the sweep
    took 0.78 ms at 256, 0.48 at 512, 0.39 at 1024; K=48 the same at each)."""
    return min(MAX_THREADS, max(32, -(-k // 32) * 32))


def nms_sweep_reference(segs: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    b, k, _ = segs.shape
    over = temporal_iou(segs[:, :, None, :], segs[:, None, :, :]) \
        > iou_threshold                                    # (B, K, K)
    lower = torch.ones(k, k, dtype=torch.bool,
                       device=segs.device).triu(1)         # j > i
    over = over & lower
    keep = torch.ones((b, k), dtype=torch.bool, device=segs.device)
    for i in range(k):
        keep = keep & ~(over[:, i] & keep[:, i:i + 1])
    return keep


def nms_sweep(segs: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """segs (B, K, 2) in rank order → keep (B, K) bool."""
    if segs.device.type == "cpu":
        nms_sweep.candidates += segs.shape[0] * segs.shape[1]
        return nms_sweep_reference(segs, iou_threshold)
    if segs.dim() == 3 and segs.shape[1] > MAX_K:
        raise ValueError(f"nms_sweep: K={segs.shape[1]} candidates a query, "
                         f"above MAX_K={MAX_K} (a block's shared memory)")
    return torch.ops.drn_tpu_torch.nms_sweep(segs, float(iou_threshold))


def nms_sweep_launch(segs: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """The custom op's CUDA kernel: the checks, the launch and its counts,
    when the op runs (an exported graph holds the op)."""
    if segs.dtype != torch.float32 or segs.dim() != 3 \
            or segs.shape[2] != 2 or not segs.is_contiguous() \
            or segs.data_ptr() % 8:
        raise ValueError(f"nms_sweep: segs must be fp32, contiguous as (B, "
                         f"K, 2), 8-byte aligned; got {segs.dtype}, shape "
                         f"{tuple(segs.shape)}, strides {segs.stride()}")
    b, k, _ = segs.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=segs.device)
    nms_sweep.candidates += b * k
    if b * k == 0:
        return keep
    fn = _build.entry("nms_sweep", "drn_nms_sweep", 2, 3, 1)
    rc = fn(segs.data_ptr(), keep.data_ptr(), b, k, sweep_threads(k),
            iou_threshold, stream_of(segs))
    if rc != 0:
        raise RuntimeError(f"nms_sweep: CUDA error {rc} at launch")
    nms_sweep.launches += 1
    return keep


# Registered through `torch.library.Library`, not `custom_op` as the
# package kernels are: a `custom_op`'s first call imports torch._dynamo
# (2.5-4.5 s), which 2D-TAN's evaluation, running no other custom op,
# would pay in its set-up.
_LIB = torch.library.Library("drn_tpu_torch", "FRAGMENT")
_LIB.define("nms_sweep(Tensor segs, float iou_threshold) -> Tensor")
_LIB.impl("nms_sweep", nms_sweep_launch, "CUDA")


@torch.library.register_fake("drn_tpu_torch::nms_sweep")
def _(segs, iou_threshold):
    return segs.new_empty(segs.shape[:2], dtype=torch.bool)


nms_sweep.launches = 0
nms_sweep.candidates = 0
