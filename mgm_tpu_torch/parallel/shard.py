"""The 1-D row mesh (counterpart of mgm_tpu/parallel/shard.py).

A mesh is an ordered list of ranks, one torch device each; rank k holds
the image rows [k * Rl, (k + 1) * Rl) of the H, Rl = ceil(H / n): the
last bands may be short or empty (H = 9 over 4 ranks: 3, 3, 3 and 0
rows), where mgm_tpu pads fake bottom rows (mgm_tpu/stereo.py:698-700);
a rank without a row runs nothing and sends nothing.  One process drives every rank of a mesh from
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
                              map, concatenated in rank order;
  cols_to_rows(parts, H, W)   rank k's (N, H, w_k, ...) band of image
                              columns, cut into every rank's rows: rank
                              j's (N, h_j, W, ...) row band.

The dense runner (halo.py) sees the same operations.  `sharded_solve`
and `solve_tiled` are mgm_tpu's dense mesh entry points: mgm_solve with
the recursion row-sharded by halo.py, the S assembly and the WTA on
each rank's band, the maps gathered.
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
        """Rows a rank: ceil(H / n) (the last ranks' bands may be short
        or empty)."""
        if H < 1:
            raise ValueError(f"a mesh shards at least one row, not {H}")
        return -(-H // self.size)

    def rows(self, H: int, k: int) -> tuple[int, int]:
        """Rank k's band of H rows (or columns): [y0, y1), maybe empty."""
        rl = self.band(H)
        return min(k * rl, H), min((k + 1) * rl, H)

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

    def on(self, k: int):
        """The context in which rank k's work is queued: its stream."""
        return _on(self.stream(k))

    def join(self, *, into_ranks: bool) -> None:
        """Order the local ranks' streams after the current streams of
        their cards (into_ranks), or the current streams after the
        ranks'."""
        for k in self.local:
            s = self.stream(k)
            if s is None:
                continue
            cur = torch.cuda.current_stream(self.devices[k])
            if into_ranks:
                s.wait_stream(cur)
            else:
                cur.wait_stream(s)

    def sharing(self, k: int) -> int:
        """The local ranks whose work runs on rank k's card at once (a
        kernel that needs all its CTAs resident plans for its share)."""
        return sum(self.devices[j] == self.devices[k] for j in self.local)

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

    def cols_to_rows(self, parts: dict, H: int, W: int) -> dict:
        """The one collective from column bands to row bands: each local
        rank k's parts[k], the (N, H, w_k, ...) band of image columns
        rows(W, k), becomes rank j's (N, h_j, W, ...) band of image rows
        rows(H, j), each piece copied once.  In one process a piece is
        copied on the receiver's stream after the sender's stream has
        reached it, and the sender's stream goes on after the copy, so
        the host never waits; under a group the pieces go as isend /
        irecv pairs (gloo through host memory).  Returns {local rank:
        row band}."""
        if self.group is not None:
            return _p2p_cols_to_rows(self, parts, H, W)
        n = self.size
        out = {}
        ref = parts[self.local[0]]
        for j in self.local:
            y0, y1 = self.rows(H, j)
            with self.on(j):   # the receiver's stream owns its band
                out[j] = torch.empty((ref.shape[0], y1 - y0, W)
                                     + ref.shape[3:], dtype=ref.dtype,
                                     device=self.devices[j])
        waits = []
        for j in self.local:
            y0, y1 = self.rows(H, j)
            sj = self.stream(j)
            for k in range(n):
                x0, x1 = self.rows(W, k)
                if x0 == x1 or y0 == y1:
                    continue
                sk = self.stream(k)
                if sj is not None:
                    sj.wait_stream(sk)
                with _on(sj):
                    out[j][:, :, x0:x1].copy_(parts[k][:, y0:y1],
                                              non_blocking=True)
                if sk is not None:
                    waits.append((sk, sj))
        for sk, sj in waits:
            sk.wait_stream(sj)
        return out

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


def _p2p_cols_to_rows(mesh: RowMesh, parts: dict, H: int, W: int) -> dict:
    """cols_to_rows under a group: this rank's piece for every other rank
    by isend, every other rank's piece for it by irecv, its own copied."""
    import torch.distributed as dist

    (k,) = mesh.local
    mine = parts[k]
    y0, y1 = mesh.rows(H, k)
    out = torch.empty((mine.shape[0], y1 - y0, W) + mine.shape[3:],
                      dtype=mine.dtype, device=mesh.devices[k])
    x0, x1 = mesh.rows(W, k)
    reqs, recv = [], []
    for j in range(mesh.size):
        r0, r1 = mesh.rows(H, j)
        c0, c1 = mesh.rows(W, j)
        if j == k:
            if y1 > y0 and x1 > x0:
                out[:, :, x0:x1].copy_(mine[:, y0:y1])
            continue
        if r1 > r0 and x1 > x0:
            reqs.append(dist.isend(_staged(mine[:, r0:r1], mesh), j,
                                   group=mesh.group))
        if y1 > y0 and c1 > c0:
            buf = torch.empty((mine.shape[0], y1 - y0, c1 - c0)
                              + mine.shape[3:], dtype=mine.dtype,
                              device=_staged_device(mine, mesh))
            reqs.append(dist.irecv(buf, j, group=mesh.group))
            recv.append((slice(c0, c1), buf))
    for r in reqs:
        r.wait()
    for cols, buf in recv:
        out[:, :, cols].copy_(buf)
    return {k: out}


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


def sharded_solve(mesh: RowMesh, cc, w8, lo, hi, s_lo, s_hi, gmin, *,
                  p1: float, p2: float, ndir: int, mgm: int,
                  use_fh: bool = False, use_weights: bool = False,
                  per_pixel: bool = False, fix_overcount: bool = True):
    """solver.mgm_solve over the mesh's row bands (mgm_tpu's
    sharded_solve, shard.py:65-82): the recursion through halo.py (K5 on
    each rank's bands), the S assembly, the overcount fix and the window
    WTA on each rank's band of rows; S, disp and cost gathered on the
    mesh's device.  Arguments and result as mgm_solve's (cc, w8 and the
    windows on any device), each element bitwise mgm_solve's."""
    from .halo import band_volumes, column_passes, cutter, solve_bands

    N, H, W, L = cc.shape
    fh_restrict = use_fh and per_pixel
    bands = band_volumes(
        mesh, H, W, cutter(cc), w8=w8 if use_weights else None,
        lo=lo if fh_restrict else None, hi=hi if fh_restrict else None,
        cols=column_passes(range(ndir)))
    res = solve_bands(mesh, H, W, bands, lo, hi, s_lo, s_hi, gmin, p1=p1,
                      p2=p2, ndir=ndir, mgm=mgm, use_fh=use_fh,
                      use_weights=use_weights, fh_restrict=fh_restrict,
                      fix_overcount=fix_overcount)
    return tuple(mesh.gather_rows({k: r[i] for k, r in res.items()}, H)
                 for i in range(3))


def solve_tiled(mesh: RowMesh, cc, w8=None, *, p1: float, p2: float,
                ndir: int, mgm: int, use_fh: bool = False,
                fix_overcount: bool = True):
    """sharded_solve for full-window problems (labels 0..L-1 everywhere,
    the mgm_o protocol; mgm_tpu's solve_tiled, shard.py:85-100): cc (N,
    H, W, L), w8 (N, H, W, 8) or None.  Returns (disp, cost), (N, H, W)
    on the mesh's device."""
    N, H, W, L = cc.shape
    i32 = dict(dtype=torch.int32, device=cc.device)
    zeros = torch.zeros((N, H, W), **i32)
    full = torch.full((N, H, W), L - 1, **i32)
    _, disp, cost = sharded_solve(
        mesh, cc, w8, zeros, full, zeros, full, torch.zeros((N,), **i32),
        p1=p1, p2=p2, ndir=ndir, mgm=mgm, use_fh=use_fh,
        use_weights=w8 is not None, fix_overcount=fix_overcount)
    return disp, cost
