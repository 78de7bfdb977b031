"""The ("data", "model", "time") mesh over a torch.distributed process group
(parallel/mesh.py), the parameters' sharding (parallel/sharding.py) and
the layers' collectives (parallel/collectives.py)."""

from drn_tpu_torch.parallel.mesh import (Mesh, all_sum, any_rank, barrier,
                                         check_axes, current_mesh,
                                         init_distributed, make_mesh,
                                         row_block, time_block, time_slice)

__all__ = ["Mesh", "all_sum", "any_rank", "barrier", "check_axes",
           "current_mesh", "init_distributed", "make_mesh", "row_block",
           "time_block", "time_slice"]
