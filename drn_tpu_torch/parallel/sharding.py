"""Tensor-parallel placement of the parameters (counterpart of
drn_tpu/parallel/mesh.py::_param_spec / param_shardings and
drn_tpu/train.py::shard_state).

JAX's rule: a leaf whose path holds `kernel`, of two or more dims, whose
last (output) dim is at least `min_width` and divisible by the model
axis's size, is split on that dim over "model"; every other leaf is
replicated. Read through convert.py's name map, that is:

  * conv kernels (K, Cin, Cout)  → nn.Conv1d weight (Cout, Cin, K): dim 0
    (the stem, the levels, the fusion convs, the FPN, the heads' towers,
    the IoU head's mixes; the heads' Cout 2 / 1 output convs stay whole
    below any `min_width`);
  * Dense kernels (Cin, Cout)    → nn.Linear weight (Cout, Cin): dim 0
    (`query_proj.{l}`);
  * an LSTM cell's per-gate kernels (In, H) → `weight_ih_l0` /
    `weight_hh_l0` (4H, ·): each gate's H-row block is split on its own
    (the blocks i, f, g, o interleave, so a plain chunk of the 4H rows
    would hand a rank whole gates);
  * the embedding table (no `kernel` in its path), every bias, LayerNorm
    and the heads' scales (1-D leaves) stay whole.

`shard_params` / `gather_params` go between a whole state dict and this
rank's blocks (a checkpoint is always whole: rank 0 writes what
`gather_params` returns, and each rank takes its block on restore, so a
directory written under one layout loads under any other, as Orbax's
global arrays do for the JAX package). `shard_model` puts a model's
parameters in blocks and gives its layers the mesh.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from drn_tpu_torch.parallel.collectives import gather_channels

_LSTM_WEIGHTS = ("weight_ih_l0", "weight_hh_l0")
# Parameters applied to time-local activations (their gradients are
# summed over the time axis): the backbone, the fusion and the FPN.
TIME_LOCAL_PARTS = ("backbone", "fusion", "fpn")
# The least output width `shard_model` splits (JAX's `tp_min_width`).
TP_MIN_WIDTH = 128


def gate_blocks(name: str) -> int:
    """Row blocks of dim 0 that split on their own: an LSTM weight's 4
    gates, else 1."""
    return 4 if name.endswith(_LSTM_WEIGHTS) else 1


def param_specs(params: Mapping[str, torch.Tensor], model_size: int,
                min_width: int = TP_MIN_WIDTH) -> Dict[str, Optional[int]]:
    """Parity-schema name → the dim it is split on over "model" (0), or
    None (replicated). `params` is a state dict or a model (its
    `state_dict()` is read)."""
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    specs = {}
    for name, p in params.items():
        width = p.shape[0] // gate_blocks(name) if p.dim() >= 2 else 0
        specs[name] = 0 if (model_size > 1 and name != "embed.weight"
                            and p.dim() >= 2 and width >= min_width
                            and width % model_size == 0) else None
    return specs


def shard(t: torch.Tensor, name: str, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s block of dim 0 of `t` (of each gate block for an
    LSTM weight)."""
    blocks = gate_blocks(name)
    rows = t.reshape(blocks, t.shape[0] // blocks, *t.shape[1:])
    n = rows.shape[1] // size
    return rows[:, rank * n:(rank + 1) * n].reshape(-1, *t.shape[1:]) \
        .contiguous()


def gather_blocks(t: torch.Tensor, name: str, group) -> torch.Tensor:
    """The whole tensor from every model rank's block (`shard`'s
    inverse, gate block by gate block), differentiable: the gradient of
    the whole is sliced back to this rank's block."""
    blocks = gate_blocks(name)
    rows = t.reshape(blocks, t.shape[0] // blocks, -1).transpose(1, 2)
    whole = gather_channels(rows, group)          # (blocks, rest, rows)
    return whole.transpose(1, 2).reshape(-1, *t.shape[1:])


def shard_params(state: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Optional[int]], rank: int,
                 size: int) -> Dict[str, torch.Tensor]:
    """A whole state dict → this model rank's (names outside `specs`,
    such as an optimizer's absent accumulator, pass unchanged)."""
    return {k: shard(v, k, rank, size) if specs.get(k) is not None else v
            for k, v in state.items()}


@torch.no_grad()
def gather_params(state: Mapping[str, torch.Tensor],
                  specs: Mapping[str, Optional[int]], group
                  ) -> Dict[str, torch.Tensor]:
    """Every model rank's blocks → the whole state dict, on every rank (a
    collective of the model group, in the state's order)."""
    return {k: gather_blocks(v, k, group) if specs.get(k) is not None
            else v for k, v in state.items()}


def shard_model(model, mesh) -> Dict[str, Optional[int]]:
    """Put `model`'s (a DRN's) parameters in this rank's blocks under
    `mesh` (at TP_MIN_WIDTH) and hand the mesh to its layers; returns the
    specs. On a CUDA model a split whose conv-kernel block the kernels do
    not build raises here (models/drn.py::DRN.set_mesh), before any
    step."""
    specs = param_specs(model, mesh.model_axis, TP_MIN_WIDTH)
    model.set_mesh(mesh, specs)
    with torch.no_grad():
        for name, p in model.state_dict(keep_vars=True).items():
            if specs[name] is not None:
                p.data = shard(p.data, name, mesh.model_rank,
                               mesh.model_axis)
    return specs


def unshard_model(model) -> None:
    """`shard_model`'s inverse, in place (a collective of the model
    group): the whole parameters on every rank, no mesh."""
    mesh, specs = model.mesh, model.specs
    if mesh is None:
        return
    whole = gather_params(model.state_dict(), specs, mesh.model_group)
    with torch.no_grad():
        for name, p in model.state_dict(keep_vars=True).items():
            p.data = whole[name]
    model.set_mesh(None, None)
