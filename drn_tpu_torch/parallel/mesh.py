"""The ("data", "model", "time") mesh over a torch.distributed process
group (counterpart of drn_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model", "time") mesh
and lets XLA's SPMD partitioner insert the collectives. The port runs one
process per GPU in a process group (NCCL on the card, gloo on the CPU),
laid out as JAX's `make_mesh` lays out its devices: rank =
((d · model) + m) · time + t, the data axis taking what the other two
leave. Launch one process per GPU with torchrun:

    torchrun --nproc_per_node=N -m drn_tpu_torch.train --distributed \
        [--model-axis M] [--time-axis S] ...

- "data": each data rank holds its row block of the same global batch
  (`row_block`). With model = time = 1 the trainer wraps the model in
  DistributedDataParallel over the whole group, the reference DRN's one
  parallelism.
- "model" (tensor parallelism): the wide kernels' output channels are
  split over the model ranks (parallel/sharding.py, the rule of JAX's
  `param_shardings`); each layer computes its channel block and gathers
  the rest (models/layers.py::ConvBlock).
- "time" (sequence parallelism): each time rank holds its block of the
  clip axis through the backbone, the fusion and the FPN, with halo rows
  from its neighbours for the k = 3 convs; the pyramid is gathered
  before the heads (`time_slice`, parallel/collectives.py).

Each axis has its sub-group (`data_group`, `model_group`, `time_group`;
None for an axis of size 1), made once a process group, collectively.
`aot_compile_synced`, the JAX package's rendezvous between an XLA
executable's compile and its first collective, has no counterpart: eager
PyTorch compiles nothing before a step, and `barrier` is the rendezvous.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from drn_tpu_torch.config import require_drn

# How long a collective or a barrier waits for a peer before it fails: a
# hang ends as an error, with room for a peer's checkpoint save or eval.
DEFAULT_TIMEOUT_S = 600.0
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def check_axes(model_axis: int = 1, time_axis: int = 1,
               world: Optional[int] = None, cfg=None) -> None:
    """Raise ValueError for a layout the port cannot run: an axis below 1,
    a world size that model · time does not divide, or (given the
    ExperimentConfig `cfg`) a clip grid whose T does not split into time
    blocks of even length at every level but the last (T divisible by
    time · 2**(num_levels-1)), which the stride-2 levels' halos and the
    FPN's upsampling need to line up across ranks. A configuration of
    another architecture than DRN splits over neither axis
    (NotImplementedError)."""
    if model_axis < 1 or time_axis < 1:
        raise ValueError(f"model_axis={model_axis}, time_axis={time_axis}: "
                         "each axis needs at least 1 rank")
    if world is not None and world % (model_axis * time_axis):
        raise ValueError(f"a world of {world} ranks does not divide into "
                         f"model_axis={model_axis} x time_axis={time_axis}")
    if cfg is not None and (model_axis > 1 or time_axis > 1):
        require_drn(cfg, "the model and time axes")
    if cfg is not None and time_axis > 1:
        t, levels = cfg.data.num_clips, cfg.model.num_levels
        unit = time_axis * 2 ** (levels - 1)
        if t % unit:
            raise ValueError(
                f"num_clips={t} does not split over time_axis={time_axis}: "
                f"T must be divisible by time · 2**(num_levels-1) = {unit}")


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
    """This process's place in the group and on each axis. `device` is
    cuda:<local rank> under NCCL, and None under gloo, where the caller
    names the device (cuda unless it asks for the CPU). `group` is the
    whole group (DDP's gradients when model = time = 1); `flags` is a gloo
    group for host-side flags and barriers, which never wait on the card.
    `data_group` carries the loss's sums, the eval counts and the
    gradients' mean; `model_group` and `time_group` the layers'
    collectives (None for an axis of size 1)."""

    rank: int
    world: int
    local_rank: int
    device: Optional[torch.device]
    group: Any
    flags: Any
    model_axis: int = 1
    time_axis: int = 1
    data_rank: int = 0
    model_rank: int = 0
    time_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    time_group: Any = None

    @property
    def data_world(self) -> int:
        return self.world // (self.model_axis * self.time_axis)

    @property
    def sharded(self) -> bool:
        """A model or time axis over more than one rank."""
        return self.model_axis > 1 or self.time_axis > 1


def _axis_groups(world: int, model: int, time: int, rank: int):
    """Every sub-group of each axis, made in the same order on every rank
    (`new_group` is collective); this rank's group of each axis (None for
    an axis of size 1; the whole group for a data axis that spans it)."""
    data = world // (model * time)
    at = lambda d, m, t: (d * model + m) * time + t  # noqa: E731
    axes = {"data": [[at(d, m, t) for d in range(data)]
                     for m in range(model) for t in range(time)],
            "model": [[at(d, m, t) for m in range(model)]
                      for d in range(data) for t in range(time)],
            "time": [[at(d, m, t) for t in range(time)]
                     for d in range(data) for m in range(model)]}
    mine = {}
    for name, groups in axes.items():
        if len(groups[0]) == 1:
            mine[name] = None
        elif len(groups[0]) == world:
            mine[name] = dist.group.WORLD
        else:
            for ranks in groups:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[name] = g
    return mine


# The meshes of the live default group, each made once: their side groups
# are made collectively, so a mesh made anew at each call would need
# every rank's call, and would leak groups each time. `_GROUP` is the
# group they were made in.
_MESHES: dict = {}
_GROUP: Any = None


def make_mesh(model_axis: int = 1, time_axis: int = 1) -> Mesh:
    """The ("data", "model", "time") mesh of the initialised default
    group, made once a group and layout (every rank must make it at the
    same point: its sub-groups are collectives)."""
    global _GROUP
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() (or "
                           "torch.distributed.init_process_group) first")
    world_group, world = dist.group.WORLD, dist.get_world_size()
    check_axes(model_axis, time_axis, world)
    if _GROUP is not world_group:
        _MESHES.clear()
        _GROUP = world_group
    key = (model_axis, time_axis)
    if key not in _MESHES:
        nccl = dist.get_backend() == "nccl"
        local = int(os.environ.get("LOCAL_RANK", 0))
        flags = next((m.flags for m in _MESHES.values()), None)
        if flags is None:
            flags = dist.new_group(backend="gloo") if nccl else world_group
        rank = dist.get_rank()
        groups = _axis_groups(world, model_axis, time_axis, rank)
        _MESHES[key] = Mesh(
            rank=rank, world=world, local_rank=local,
            device=torch.device("cuda", local) if nccl else None,
            group=world_group, flags=flags, model_axis=model_axis,
            time_axis=time_axis,
            data_rank=rank // (model_axis * time_axis),
            model_rank=rank // time_axis % model_axis,
            time_rank=rank % time_axis, data_group=groups["data"],
            model_group=groups["model"], time_group=groups["time"])
    return _MESHES[key]


def current_mesh() -> Optional[Mesh]:
    """The data mesh (`make_mesh()`: every rank on the data axis) of the
    initialised process group, else None. A model or time layout is never
    implied: a caller that wants one passes its mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return make_mesh()


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


def time_block(t: int, mesh: Optional[Mesh]) -> tuple:
    """This time rank's rows [start, end) of a T-row clip axis."""
    if mesh is None or mesh.time_axis == 1:
        return 0, t
    n = t // mesh.time_axis
    return mesh.time_rank * n, (mesh.time_rank + 1) * n


# The stem's k = 3 window: rows a time rank reads beyond its block.
STEM_HALO = 1


def time_slice(batch: dict, mesh: Optional[Mesh]) -> dict:
    """The batch a time rank moves to its device: its block of the
    features' clip axis, with STEM_HALO rows on each side where the clip
    axis goes on (models/backbone.py trims the stem's output to the
    block). Every other array is the whole batch's."""
    if mesh is None or mesh.time_axis == 1 or "features" not in batch:
        return batch
    t = batch["features"].shape[1]
    s, e = time_block(t, mesh)
    return {**batch, "features": batch["features"][
        :, max(s - STEM_HALO, 0):min(e + STEM_HALO, t)]}


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
