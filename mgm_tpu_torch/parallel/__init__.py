"""Row sharding of the stereo pipeline over several ranks (counterpart
of mgm_tpu/parallel): `make_mesh` for ranks driven by one process,
`distributed` for one rank a process over torch.distributed; the fused
branch's recursion through K4 (fused_shard.py), the dense recursion
through K5 on a band (halo.py: `halo_aggregate`, and `sharded_solve` /
`solve_tiled`, mgm_solve over the mesh)."""
from .shard import RowMesh, make_mesh, sharded_solve, solve_tiled
from .fused_shard import sharded_eligible, sharded_fused_planes
from .halo import halo_aggregate

__all__ = ["RowMesh", "halo_aggregate", "make_mesh", "sharded_eligible",
           "sharded_fused_planes", "sharded_solve", "solve_tiled"]
