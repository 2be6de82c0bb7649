"""The 1-D row mesh (counterpart of mgm_tpu/parallel/shard.py).

A mesh is an ordered list of ranks, one torch device each; rank k holds
the image rows [k * Rl, (k + 1) * Rl), Rl = ceil(H / n) (the last band
may be short).  One process drives every rank of a mesh from
`make_mesh`, as one JAX controller drives every local device; a device
may repeat, so `make_mesh(devices=["cuda:0"] * 4)` runs four ranks on
one card and `["cpu"] * 2` two on the CPU.  A mesh from
`distributed.global_row_mesh` has one rank a process and exchanges
through torch.distributed.

The sharded runner (fused_shard.py) sees only two operations, so it
does not know which kind of mesh it runs on:

  shift(tensors, step)   rank k's tensor goes to rank k + step, then
                         every rank waits for what it receives;
  gather_rows(bands, H)  every rank's band of an (N, rows, ...) map,
                         concatenated in rank order.

The dense XLA mesh path of mgm_tpu (`sharded_solve`, `solve_tiled`,
`halo.halo_aggregate`) is not ported yet (ROADMAP item 10a).
"""
from __future__ import annotations

import torch


class RowMesh:
    """Ranks 0..n-1 over `devices` (one torch.device a rank).  `local`
    lists the ranks this process drives: every rank, or its own under a
    torch.distributed `group` (whose backend then carries the
    exchanges)."""

    def __init__(self, devices, local=None, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        self.local = list(range(len(self.devices)) if local is None
                          else local)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device of this process's first rank: where the prep and
        the post stages run."""
        return self.devices[self.local[0]]

    @property
    def writes(self) -> bool:
        """True in the process that holds rank 0 (the one that writes
        the outputs of a run over several processes)."""
        return 0 in self.local

    def band(self, H: int) -> int:
        """Rows a rank: ceil(H / n).  Every rank must hold a real row."""
        n = self.size
        rl = -(-H // n)
        if (n - 1) * rl >= H:
            raise ValueError(f"{H} rows leave rank {n - 1} of {n} without a "
                             f"row ({rl} rows a rank)")
        return rl

    def shift(self, tensors: dict, step: int) -> dict:
        """Send each local rank k's tensors[k] to rank k + step (step
        +-1) and wait: returns {k: the tensor rank k - step sent, or None
        at the mesh's edge} for the local ranks.  Every rank's tensor has
        one shape and dtype.  What is received is a fresh tensor."""
        n = self.size
        if self.group is None:
            # in one process: a copy onto the receiver's device (on
            # distinct cards torch orders it after the sender's stream)
            return {k: (tensors[k - step].to(self.devices[k], copy=True)
                        if 0 <= k - step < n else None)
                    for k in self.local}
        return _p2p_shift(self, tensors, step)

    def gather_rows(self, bands: dict, H: int, dim: int = 1):
        """The (..., H, ...) map from every rank's band of it (rows on
        `dim`, Rl rows a rank, fewer on the last), on self.device."""
        if self.group is None:
            return torch.cat([bands[k].to(self.device)
                              for k in range(self.size)], dim)
        return _all_gather_rows(self, bands, H, dim)


def make_mesh(n_devices: int | None = None, devices=None) -> RowMesh:
    """A 1-D row mesh driven by this process: over `devices` (names or
    torch.devices, repeats allowed), else over the first `n_devices`
    CUDA cards (all of them by default)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to "
                               "run the ranks on the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"{n} ranks on {count} CUDA devices: pass "
                             f"devices= to place several ranks on one card")
        devices = [f"cuda:{k}" for k in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return RowMesh(devices)


def _staged(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """What goes over the group's backend: gloo's point-to-point and
    collectives take CPU tensors only, so a CUDA tensor goes through
    host memory there (several processes on one card: NCCL refuses two
    ranks on one GPU).  NCCL takes the device tensor as it is."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "gloo":
        return t.detach().cpu().contiguous()
    return t.contiguous()


def _p2p_shift(mesh: RowMesh, tensors: dict, step: int) -> dict:
    import torch.distributed as dist

    n = mesh.size
    (k,) = mesh.local
    reqs, recv = [], None
    if 0 <= k + step < n:
        reqs.append(dist.isend(_staged(tensors[k], mesh), k + step,
                               group=mesh.group))
    if 0 <= k - step < n:
        recv = _staged(torch.empty_like(tensors[k]), mesh)
        reqs.append(dist.irecv(recv, k - step, group=mesh.group))
    for r in reqs:
        r.wait()
    return {k: None if recv is None else recv.to(mesh.devices[k])}


def _all_gather_rows(mesh: RowMesh, bands: dict, H: int, dim: int):
    import torch.distributed as dist

    n = mesh.size
    (k,) = mesh.local
    rl = mesh.band(H)
    mine = bands[k]
    if mine.shape[dim] < rl:   # the short last band: pad to one shape
        pad = list(mine.shape)
        pad[dim] = rl - mine.shape[dim]
        mine = torch.cat([mine, mine.new_zeros(pad)], dim)
    mine = _staged(mine, mesh)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts, dim).narrow(dim, 0, H).to(mesh.device)


def sharded_solve(*args, **kwargs):
    """The dense mesh path (mgm_tpu.parallel.shard.sharded_solve) is not
    ported yet."""
    raise NotImplementedError("sharded_solve: the dense mesh path is "
                              "ROADMAP item 10a, not ported yet")


def solve_tiled(*args, **kwargs):
    """The dense mesh path (mgm_tpu.parallel.shard.solve_tiled) is not
    ported yet."""
    raise NotImplementedError("solve_tiled: the dense mesh path is "
                              "ROADMAP item 10a, not ported yet")
