"""Data parallelism over a torch.distributed process group (counterpart of
drn_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model", "time") mesh
and lets XLA's SPMD partitioner insert the collectives. The port has the
"data" axis: one process per GPU in a process group (NCCL on the card,
gloo on the CPU), the model replicated in every process and wrapped in
DistributedDataParallel by the trainer, each rank holding its row block
of the same global batch (`row_block`). The reference DRN's only
parallelism is DDP, so this is the parity configuration. Launch one
process per GPU with torchrun:

    torchrun --nproc_per_node=N -m drn_tpu_torch.train --distributed ...

Tensor and sequence parallelism (`model_axis` or `time_axis` > 1) are not
ported: `make_mesh` raises (ROADMAP.md §A item 5). The JAX package's
`param_shardings` (TP over wide kernels' output channels) and
`feature_sharding` (the clip axis over "time") belong to them and have no
counterpart here; nor has `aot_compile_synced`, the rendezvous between
an XLA executable's compile and its first collective: eager PyTorch
compiles nothing before a step, and `barrier` is the rendezvous.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

# How long a collective or a barrier waits for a peer before it fails: a
# hang ends as an error, with room for a peer's checkpoint save or eval.
DEFAULT_TIMEOUT_S = 600.0
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def check_axes(model_axis: int = 1, time_axis: int = 1) -> None:
    """Raise for a tensor- or sequence-parallel layout."""
    if model_axis > 1 or time_axis > 1:
        raise NotImplementedError(
            f"model_axis={model_axis}, time_axis={time_axis}: tensor and "
            "sequence parallelism are not ported (ROADMAP.md §A item 5); "
            "the port runs data parallel only")


def init_distributed(device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """`init_process_group` from the torchrun environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL when `device`
    is cuda (the default), gloo when it is the CPU. On cuda the process's
    current device becomes cuda:<LOCAL_RANK> first, before any kernel is
    built or launched. Returns this rank's device."""
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs the torchrun environment; "
                           f"{', '.join(missing)} unset (launch with "
                           "torchrun --nproc_per_node=N)")
    dev = torch.device("cuda" if device is None else device)
    backend = "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU "
                               "unless the caller passes device='cpu'")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@dataclass(frozen=True)
class Mesh:
    """The data axis: this process's place in the group. `device` is
    cuda:<local rank> under NCCL, and None under gloo, where the caller
    names the device (cuda unless it asks for the CPU). `group` carries
    the collectives (DDP's gradients, the loss's sums, the eval counts);
    `flags` is a gloo group for host-side flags and barriers, which never
    wait on the card."""

    rank: int
    world: int
    local_rank: int
    device: Optional[torch.device]
    group: Any
    flags: Any


# The mesh of the live default group, made once: its gloo side group is
# made collectively, so a mesh made anew at each call would need every
# rank's call, and would leak a group each time.
_MESH: Optional[Mesh] = None


def make_mesh(model_axis: int = 1, time_axis: int = 1) -> Mesh:
    """The data-parallel mesh of the initialised default group, made once
    a group (every rank must make it at the same point: the gloo side
    group under NCCL is a collective); `model_axis` or `time_axis` > 1
    raises."""
    global _MESH
    check_axes(model_axis, time_axis)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() (or "
                           "torch.distributed.init_process_group) first")
    world_group = dist.group.WORLD
    if _MESH is None or _MESH.group is not world_group:
        nccl = dist.get_backend() == "nccl"
        local = int(os.environ.get("LOCAL_RANK", 0))
        _MESH = Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                     local_rank=local,
                     device=torch.device("cuda", local) if nccl else None,
                     group=world_group,
                     flags=dist.new_group(backend="gloo") if nccl
                     else world_group)
    return _MESH


def current_mesh() -> Optional[Mesh]:
    """`make_mesh()` inside an initialised process group, else None."""
    return make_mesh() if dist.is_available() and dist.is_initialized() \
        else None


def row_block(batch, rank: int, world: int,
              batch_size: Optional[int] = None):
    """Rank `rank`'s block of a global batch of B rows split into `world`
    equal blocks: rows [rank·b, (rank+1)·b), b = B / world, of every array
    of a dict, or of one sequence. `batch_size` is B where the sequence is
    shorter (the example indices of a ragged last batch, whose padding
    rows come last): the block is then what is left of it, maybe
    nothing."""
    if isinstance(batch, dict):
        return {k: row_block(v, rank, world, batch_size)
                for k, v in batch.items()}
    b_all = len(batch) if batch_size is None else batch_size
    assert b_all % world == 0, (
        f"batch of {b_all} rows does not split over {world} ranks")
    b = b_all // world
    return batch[rank * b:(rank + 1) * b]


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over `group`'s ranks of `t`, as a new tensor outside autograd."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is True on any rank of the process
    group (no group: `flag`): a MAX over the gloo side group on a CPU
    tensor, so the host never waits on the card."""
    mesh = current_mesh()
    if mesh is None or mesh.world == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.flags)
    return bool(t.item())


def barrier(name: str) -> None:
    """Every rank waits here for the others (the counterpart of the JAX
    package's `coordination_barrier`), on the gloo side group; no-op
    outside a process group. `name` labels the failure of a barrier a
    peer never reached."""
    mesh = current_mesh()
    if mesh is None:
        return
    try:
        dist.barrier(group=mesh.flags)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
