"""Data parallelism over a torch.distributed process group (parallel/mesh.py)."""

from drn_tpu_torch.parallel.mesh import (Mesh, all_sum, any_rank, barrier,
                                         check_axes, current_mesh,
                                         init_distributed, make_mesh,
                                         row_block)

__all__ = ["Mesh", "all_sum", "any_rank", "barrier", "check_axes",
           "current_mesh", "init_distributed", "make_mesh", "row_block"]
