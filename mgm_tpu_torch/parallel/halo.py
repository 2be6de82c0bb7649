"""The dense recursion row-sharded over a mesh, through K5 on a band
(counterpart of mgm_tpu/parallel/halo.py).

mgm_tpu's `halo_aggregate` shards the skewed volume of each pass group
on canonical rows and runs the recursion as a lax.scan with a ppermute
of each band's last row (values and cached minimum) after every front
(halo.py:27-138).  Here each rank holds its band of canonical rows in
image layout and steps K5 on the band (ops/wavefront.bind_band: a block
of G fronts a launch, the recursion's state in the band's output from
block to block), and the ranks exchange the band's last row between
blocks, not between fronts:

  - A canonical row band is a band of image rows for a row-major pass
    and a band of image columns for a column-major one.  Every rank
    therefore holds two volumes: its band of image rows (N, h, W, L)
    and its band of image columns (N, H, w, L) (`band_volumes`; the
    column one only when a column-major pass runs).
  - A pass group mixes passes whose canonical rows run down the image
    (or right) and passes whose rows run up (or left): each sign is a
    sub-launch, and in it rank k runs block b at superstep b + q (q:
    its place along the flow), after the rank upstream has run it.
    After each superstep a rank ships the (G, M, L) track of its band's
    last row (and its minima) into slot b mod 2 of the downstream rank's
    halo ring, whose first row reads it in block b (and block b - 1's
    in the other slot: a dep reaches back at most 4 < G fronts).  A
    rank skips the blocks in which its band has no pixel; a rank
    without a row runs none.
  - A group's passes are summed on the band in the unsharded order; a
    column-major group's sum goes from the column bands to the row
    bands (RowMesh.cols_to_rows), and the groups add up in
    ops.aggregate's order, so every element of a rank's row band is
    bitwise the unsharded aggregate's.

In one process each rank runs on its own CUDA stream (RowMesh.stream)
and the exchanges are ordered by CUDA events: nothing in the recursion
waits on the host.  Under torch.distributed the tracks and the column
pieces go as point-to-point messages (shard.py).
"""
from __future__ import annotations

import torch

from ..ops import wavefront as wf
from ..ops.aggregate import PASS_TABLE, _pass_groups, group_plan, scan_kwargs
from ..ops.cost import build_cost_volume
from .fused_shard import BLOCK, staggered


def column_passes(pids) -> bool:
    """Whether any of the passes `pids` runs column-major (its canonical
    rows are image columns: the ranks need their column bands)."""
    return any(not PASS_TABLE[p].row_major for p in pids)


def cutter(cc):
    """band_volumes' `build` for a whole (N, H, W, L) volume: the
    window's copy on the rank's device."""
    return lambda rows, cols, dev: cc[:, rows, cols].to(dev).contiguous()


def pair_bands(mesh, u, v, lo, hi, gmins, *, distance: str, L: int,
               trunc_dist: float, ncc_win: int = 3, w8=None,
               fh_restrict: bool = False, pids) -> dict:
    """band_volumes of one stereo pair's sides, each rank building its
    bands' cost volumes (ops.cost.build_cost_volume: K8, or NCC with its
    window's apron) from the whole prepped images u, v (H, W, nch): side
    s of N = len(gmins) matches (u, v) (s = 0) or (v, u) over the label
    windows lo[s], hi[s] ((N, H, W) int32) from disparity gmins[s].
    fh_restrict: the recursion reads the windows (they are cut too);
    pids: the passes that will run."""
    H, W = u.shape[:2]
    on_dev = {}

    def build(rows, cols, dev):
        if dev not in on_dev:
            on_dev[dev] = tuple(a.to(dev) for a in (u, v, lo, hi))
        a, b, lo_d, hi_d = on_dev[dev]
        out = torch.empty((len(gmins), len(range(H)[rows]),
                           len(range(W)[cols]), L), dtype=torch.float32,
                          device=dev)
        for s, g in enumerate(gmins):
            build_cost_volume(*((a, b) if s == 0 else (b, a)), lo_d[s],
                              hi_d[s], g, distance=distance, L=L,
                              trunc_dist=trunc_dist, ncc_win=ncc_win,
                              out=out[s], rows=rows, cols=cols)
        return out

    return band_volumes(mesh, H, W, build, w8=w8,
                        lo=lo if fh_restrict else None,
                        hi=hi if fh_restrict else None,
                        cols=column_passes(pids))


def band_volumes(mesh, H: int, W: int, build, *, w8=None, lo=None, hi=None,
                 cols: bool = True) -> dict:
    """Each local rank's inputs of the dense recursion, on its device:
    {k: {"row": (cc, w8, lo, hi), "col": ... or None}}.  `build(rows,
    cols, device)` makes the (N, rows, cols, L) volume of the image
    window rows x cols (slices) on `device`; w8 (N, H, W, 8) and the
    windows lo/hi (N, H, W) (or None) are cut alike.  `cols`: whether a
    column-major pass runs (the band of image columns is made only
    then).  Each rank's work runs on its stream, after the current
    stream's work (which made the inputs)."""
    out = {}
    full_r, full_c = slice(0, H), slice(0, W)
    mesh.join(into_ranks=True)

    def cut(a, rows, cls, dev):
        return None if a is None else a[:, rows, cls].to(dev).contiguous()

    for k in mesh.local:
        dev = mesh.devices[k]
        bands = {}
        with mesh.on(k):
            for side, (rows, cls) in (
                    ("row", (slice(*mesh.rows(H, k)), full_c)),
                    ("col", (full_r, slice(*mesh.rows(W, k))))):
                if side == "col" and not cols:
                    bands[side] = None
                    continue
                bands[side] = (build(rows, cls, dev),
                               *(cut(a, rows, cls, dev) for a in (w8, lo, hi)))
        out[k] = bands
    return out


def aggregate_bands(mesh, H: int, W: int, bands: dict, *, p1: float,
                    p2: float, ndir: int, mgm: int, use_fh: bool = False,
                    use_weights: bool = False, fh_restrict: bool = False,
                    pids=None, block: int | None = None,
                    kernel=None) -> dict:
    """ops.aggregate row-sharded over the mesh: {local rank k: the sum
    over the first `ndir` passes (or `pids`) of the aggregated volumes
    on its band of image rows, (N, h_k, W, L)}, each element bitwise
    the unsharded aggregate's.  bands: band_volumes' inputs; block: the
    fronts a launch (BLOCK when None; any block >= 4 gives the same
    bits); kernel: K5 on a band (wavefront_band, the default) or its
    plain version (wavefront_band_plain, as the smoke run compares).
    Arguments otherwise as ops.aggregate's (fh_restrict before its
    mgm-2 rule)."""
    if fh_restrict:
        # aggregate's rule: the MGM==2 unweighted FH path takes the
        # full-axis min-conv (mgm_core.cc:208)
        fh_restrict = not (mgm == 2 and not use_weights)
    run = _Bands(mesh, H, W, bands, kernel or wf.wavefront_band,
                 block or BLOCK,
                 dict(p1=p1, p2=p2, mgm=mgm, use_fh=use_fh,
                      use_weights=use_weights, fh_restrict=fh_restrict))
    mesh.join(into_ranks=True)
    total = {k: None for k in mesh.local}
    for g in _pass_groups(ndir, mgm, pids):
        rm = PASS_TABLE[g[0]].row_major
        outs = {k: {} for k in mesh.local}
        for flip in (False, True):
            sub = [p for p in g if (PASS_TABLE[p].flip_y if rm
                                    else PASS_TABLE[p].flip_x) == flip]
            if sub:
                for k, o in run.stagger(sub, rm, flip).items():
                    outs[k].update(zip(sub, o))
        part = {}
        for k in mesh.local:
            with mesh.on(k):
                # the group's passes in the unsharded order (sum_passes)
                acc = outs[k][g[0]]
                for p in g[1:]:
                    acc = acc + outs[k][p]
                part[k] = acc
        del outs
        if not rm:
            part = mesh.cols_to_rows(part, H, W)
        for k in mesh.local:
            with mesh.on(k):
                total[k] = (part[k] if total[k] is None
                            else total[k] + part[k])
        del part
    mesh.join(into_ranks=False)
    return total


def solve_bands(mesh, H: int, W: int, bands: dict, lo, hi, s_lo, s_hi, gmin,
                *, ndir: int, fix_overcount: bool = True, **kw) -> dict:
    """solver.mgm_solve on each rank's band of rows: the recursion
    row-sharded (aggregate_bands, with `kw`), then the S assembly, the
    overcount fix and the window WTA (solver.assemble_wta) on the band,
    on the rank's stream.  lo/hi (the recursion windows), s_lo/s_hi:
    the whole (N, H, W) windows; gmin: (N,).  Returns {local rank: (S,
    disp, cost) of its rows}."""
    from ..solver import assemble_wta

    lsum = aggregate_bands(mesh, H, W, bands, ndir=ndir, **kw)
    res = {}
    for k in mesh.local:
        rows = slice(*mesh.rows(H, k))
        dev = mesh.devices[k]
        with mesh.on(k):
            res[k] = assemble_wta(
                lsum.pop(k), bands[k]["row"][0],
                *(a[:, rows].to(dev) for a in (lo, hi, s_lo, s_hi)),
                gmin.to(dev), ndir=ndir, fix_overcount=fix_overcount)
    mesh.join(into_ranks=False)
    return res


class _Bands:
    """The ranks' band inputs, K5-band and the scan's fixed arguments for
    one sharded aggregation."""

    def __init__(self, mesh, H, W, bands, kernel, G, common):
        self.mesh, self.H, self.W, self.bands = mesh, H, W, bands
        self.kernel, self.G, self.common = kernel, G, common

    def stagger(self, pids, rm: bool, flip: bool) -> dict:
        """The passes `pids` (one canonical flow sign) over the ranks'
        bands: {local rank: (B, N, h, w, L) each pass's aggregated
        volume on the rank's band (of image rows when `rm`, else of
        image columns)}."""
        mesh, G = self.mesh, self.G
        n = mesh.size
        Rg, C = (self.H, self.W) if rm else (self.W, self.H)
        flow = -1 if flip else 1       # the rank downstream: k + flow
        ext = [mesh.rows(Rg, k) for k in range(n)]
        # global canonical row of each band's row 0, and its rows
        r0 = [Rg - b if flip else a for a, b in ext]
        nr = [b - a for a, b in ext]
        mgm = self.common["mgm"]
        slope = group_plan(pids, self.H, self.W, mgm).slope
        T = C + slope * (Rg - 1)
        # the fronts with a pixel of each band (front t: column t - slope
        # * global row)
        live = [(slope * r0[k], slope * (r0[k] + nr[k] - 1) + C - 1)
                if nr[k] else None for k in range(n)]

        def real(k):
            return 0 <= k < n and nr[k] > 0

        outs, halo, ship, step = {}, {}, {}, {}
        for k in mesh.local:
            cc, w8, lo, hi = self.bands[k]["row" if rm else "col"]
            N, h, w, L = cc.shape
            B, M = len(pids), len(pids) * N
            f32 = dict(dtype=torch.float32, device=mesh.devices[k])
            with mesh.on(k):
                outs[k] = torch.empty((B, N, h, w, L), **f32)
                halo[k] = ship[k] = None
                if not nr[k]:
                    continue
                if r0[k] > 0:
                    halo[k] = (torch.full((2 * G, M, L), float("inf"), **f32),
                               torch.full((2 * G, M), float("inf"), **f32))
                if real(k + flow):
                    ship[k] = (torch.empty((G, M, L), **f32),
                               torch.empty((G, M), **f32))
                plan = group_plan(pids, h, w, mgm)
                step[k] = wf.bind_band(
                    self.kernel, cc, w8, lo, hi, outs[k],
                    torch.empty((M, plan.R, plan.C), **f32), halo=halo[k],
                    ship=ship[k], r0=r0[k], G=G, share=mesh.sharing(k),
                    **scan_kwargs(plan, **self.common))
        staggered(mesh, flow=flow, nb=-(-T // G), G=G, live=live,
                  step=step, ship=ship, halo=halo)
        return outs


def halo_aggregate(mesh, cc, w8=None, *, p1: float, p2: float, ndir: int,
                   mgm: int, use_fh: bool = False, use_weights: bool = False):
    """Directional aggregation over the mesh's row bands (mgm_tpu's
    halo_aggregate, halo.py:141-213): cc (N, H, W, L) dense costs (+inf
    outside label windows), w8 (N, H, W, 8) edge weights when
    use_weights; returns the (N, H, W, L) sum of the aggregated volumes
    over the first `ndir` passes, gathered on the mesh's device, bitwise
    ops.aggregate's.  Any H and W over any number of ranks."""
    N, H, W, L = cc.shape
    bands = band_volumes(mesh, H, W, cutter(cc),
                         w8=w8 if use_weights else None,
                         cols=column_passes(range(ndir)))
    lsum = aggregate_bands(mesh, H, W, bands, p1=p1, p2=p2, ndir=ndir,
                           mgm=mgm, use_fh=use_fh, use_weights=use_weights)
    return mesh.gather_rows(lsum, H)
