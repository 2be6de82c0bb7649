"""The 1-D row mesh (counterpart of mgm_tpu/parallel/shard.py).

A mesh is an ordered list of ranks, one torch device each; rank k holds
the image rows [k * Rl, (k + 1) * Rl), Rl = ceil(H / n) (the last band
may be short).  One process drives every rank of a mesh from
`make_mesh`, as one JAX controller drives every local device; a device
may repeat, so `make_mesh(devices=["cuda:0"] * 4)` runs four ranks on
one card and `["cpu"] * 2` two on the CPU.  On CUDA devices each rank
of such a mesh works on a stream of its own (`stream`), so ranks that
share a card overlap there as they would on cards of their own, and
the exchanges between them are ordered by CUDA events, never by the
host.  A mesh from `distributed.global_row_mesh` has one rank a
process and exchanges through torch.distributed.

The sharded runner (fused_shard.py) sees only these operations, so it
does not know which kind of mesh it runs on:

  stream(k)                   rank k's CUDA stream, or None (the
                              current stream);
  shift(tensors, step, out)   rank k's tensor is copied into rank
                              k + step's `out`;
  gather_rows(bands, H)       every rank's band of an (N, rows, ...)
                              map, concatenated in rank order.

The dense XLA mesh path of mgm_tpu (`sharded_solve`, `solve_tiled`,
`halo.halo_aggregate`) is not ported yet (ROADMAP item 10a).
"""
from __future__ import annotations

import contextlib

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
        self._streams = {}

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

    def stream(self, k: int):
        """Rank k's CUDA stream (made at first use) when this process
        drives every rank on CUDA devices, else None: the current stream
        (CPU ranks; one rank a process, whose exchanges the group's
        backend orders)."""
        if self.group is not None or self.devices[k].type != "cuda":
            return None
        if k not in self._streams:
            self._streams[k] = torch.cuda.Stream(self.devices[k])
        return self._streams[k]

    def shift(self, tensors: dict, step: int, out: dict) -> None:
        """Copy each local rank k's tensors[k] into out[k + step] (step
        +-1): a tensor, or a tuple of tensors, of one shape and dtype on
        every rank.  A None entry sends or receives nothing (the
        receiver's entry must then be None too, and the other way
        round); the rank at the mesh's edge receives nothing.  In one
        process the host never waits: the copy runs on the receiver's
        stream after the sender's stream has reached it, and the
        sender's stream goes on only after the copy, so either may
        overwrite its tensor next."""
        n = self.size
        if self.group is not None:
            _p2p_shift(self, tensors, step, out)
            return
        waits = []
        for k in self.local:
            j = k - step
            if not 0 <= j < n or out.get(k) is None:
                continue
            sj, sk = self.stream(j), self.stream(k)
            if sk is not None:
                sk.wait_stream(sj)
            with _on(sj), _on(sk):
                for d, s in zip(_parts(out[k]), _parts(tensors[j])):
                    d.copy_(s, non_blocking=True)
            if sj is not None:
                waits.append((sj, sk))
        for sj, sk in waits:
            sj.wait_stream(sk)

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


def _on(stream):
    """The context that makes `stream` current (None: nothing)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(
        stream)


def _parts(x) -> tuple:
    """A shift's entry as a tuple of tensors."""
    return x if isinstance(x, tuple) else (x,)


def _staged(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """What goes over the group's backend: gloo's point-to-point and
    collectives take CPU tensors only, so a CUDA tensor goes through
    host memory there (several processes on one card: NCCL refuses two
    ranks on one GPU).  NCCL takes the device tensor as it is."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "gloo":
        return t.detach().cpu().contiguous()
    return t.contiguous()


def _staged_device(t: torch.Tensor, mesh: RowMesh):
    """Where _staged puts a copy of t: host memory under gloo."""
    import torch.distributed as dist

    return "cpu" if dist.get_backend(mesh.group) == "gloo" else t.device


def _p2p_shift(mesh: RowMesh, tensors: dict, step: int, out: dict):
    import torch.distributed as dist

    n = mesh.size
    (k,) = mesh.local
    send = tensors.get(k) if 0 <= k + step < n else None
    into = out.get(k) if 0 <= k - step < n else None
    reqs, recv = [], []
    if send is not None:
        for t in _parts(send):
            reqs.append(dist.isend(_staged(t, mesh), k + step,
                                   group=mesh.group))
    if into is not None:
        for t in _parts(into):
            buf = torch.empty(t.shape, dtype=t.dtype,
                              device=_staged_device(t, mesh))
            reqs.append(dist.irecv(buf, k - step, group=mesh.group))
            recv.append((t, buf))
    for r in reqs:
        r.wait()
    for t, buf in recv:
        t.copy_(buf)


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
