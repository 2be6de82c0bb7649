"""Row sharding of the stereo pipeline over several ranks (counterpart
of mgm_tpu/parallel): `make_mesh` for ranks driven by one process,
`distributed` for one rank a process over torch.distributed."""
from .shard import RowMesh, make_mesh, sharded_solve, solve_tiled
from .fused_shard import sharded_eligible, sharded_fused_planes

__all__ = ["RowMesh", "make_mesh", "sharded_eligible",
           "sharded_fused_planes", "sharded_solve", "solve_tiled"]
