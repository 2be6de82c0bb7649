"""The fused recursion row-sharded over a mesh, through K4 (counterpart
of mgm_tpu/parallel/fused_shard.py).

Every rank holds its band of image rows (shard.py) and the whole
images, weights and windows (megabytes; the (planes, rows, C, L) volume
is what is sharded).  It steps K4 (cuda_fused.fused_block: a block of G
scan steps of K1's recursion on the band's rows in one launch, the ring
carried from block to block) and exchanges boundary rows between
blocks, so that each band's volume is bitwise the single-device K1
volume's rows.  K4's fixed arguments are bound once a sub-launch or
lockstep group (cuda_fused.bind_block), so a block's call sets only its
first step.  In one process each rank runs on its own CUDA stream
(RowMesh.stream) and the exchanges are ordered by CUDA events: nothing
in the recursion waits on the host, and ranks that share a card
overlap on it as on cards of their own.

  - A/B groups (skewed fronts, slope 1 or 2) run as a staggered one-way
    pipeline.  K1 runs A and B in one launch, whose row rolls have both
    signs; here each (space, direction) is a sub-launch whose rolls
    have one sign (the skew is what makes the deps causal).  When they
    read the row above, rank k runs block sigma - k at superstep sigma
    (sigma - (n - 1 - k) when they read the row below), so a band runs
    block b one superstep after its upstream neighbour.  After each
    superstep a rank ships the (G, Ml, L) track of its edge row (K4's
    ship) to the downstream rank, into slot b mod 2 of its halo, a ring
    of two G-step tracks (step s at entry s mod 2G), which its first
    row reads in block b, and block b - 1's track in the other slot
    (every dep reaches back at most D <= 3 < G steps).  A band skips
    the blocks in which it has no pixel.
  - V (slope-0 column fronts) and the parity spaces PA/PB read rows
    above and below, so no one-way order exists.  Every rank runs every
    block of B = min(G, Rl) steps in lockstep over its band extended by
    B apron rows a side; an apron row's error reaches at most one row
    further each step, so after B steps only the aprons are wrong, and
    between blocks each rank refreshes its aprons' ring rows from the
    neighbours' band rows (JAX's lockstep apron scheme,
    fused_shard.py:343-351), copied straight between the rings' rows.
    The port does not pack half-rows (csrc/fused_wavefront.cu), so the
    parity group's aprons are image rows, as V's are.

The border rule and the front map use image rows against the image's
R; rows past R (the last band's padding) and above row 0 are skipped.
Spaces keep K1's order A, B, V, PA, PB, so K2 sums each band's planes
as on one device.
"""
from __future__ import annotations

import torch

from ..ops import cuda_fused
from ..ops.common import INF
from ..ops.fused import group_launches, split_passes

# scan steps a block (mgm_tpu's G is 32, fused_shard.py:312, :552, :646).
# Any G >= the deepest lag gives the same bits.  64: against 32, half the
# launches and hand-offs of a block (on one H100, cfg1's recursion over 4
# ranks 39.8 -> 31.5 ms, cfg1_tsgm4's 130 -> 68 ms), for a stagger bubble
# (nb + n - 1) / nb on cards of their own of 1.05 against 1.03 at 2
# ranks (PERF.md section 6)
BLOCK = 64


def sharded_eligible(ndir: int, mgm: int, distance: str) -> bool:
    """True when every pass falls in a group the sharded runner covers
    (A/B, V or the parity spaces): ndir <= 8 at any TSGM, not NCC
    (mgm_tpu fused_shard.py:178-190)."""
    if distance == "ncc":
        return False
    groups, leftover = split_passes(ndir, mgm)
    return not leftover and bool(groups)


def sharded_fused_planes(lefts, rights, *, mesh, sides, L: int, groups,
                         mgm: int, p1: float, p2: float, mode: str,
                         tmax: float, kappa: float, use_fh: bool = False,
                         w8=None, lo_px=None, hi_px=None,
                         fh_restrict: bool = False, block: int | None = None,
                         kernel=None):
    """Every launch of `groups` (split_passes, no leftover passes) over
    the mesh's row bands in blocks of `block` steps (BLOCK when None;
    any block >= the deepest lag gives the same bits), through `kernel`
    (K4, cuda_fused.fused_block, when None; the smoke run passes its
    plain version to compare).  The counterpart of mgm_tpu's
    sharded_fused_lsum before its space sum: K2 sums each band's spaces
    as on one device.

    lefts/rights: (N, H, W, nch) images of each side of one pair as K1
    takes them; w8, lo_px/hi_px: as for ops.fused.fused_planes; all on
    any device (each rank takes a copy on its own).  The first group
    folds kappa * CC.  Returns ({rank: (r0, volume)}, nspaces) for the
    local ranks: the (nspaces * N, h, W, L) volume of image rows
    r0 .. r0 + h - 1, spaces in the order A, B, V, PA, PB."""
    kernel = kernel or cuda_fused.fused_block
    N, H, C, _ = lefts.shape
    rl = mesh.band(H)
    nspaces = sum(len(spaces) for _, spaces, _ in groups)
    run = _Run(mesh, kernel, H=H, C=C, rl=rl, block=block or BLOCK,
               inputs=dict(left=lefts, right=rights, w8=w8, lo_px=lo_px,
                           hi_px=hi_px),
               common=dict(L=L, mgm=mgm, mode=mode, tmax=tmax, p1=p1,
                           p2=p2, kappa=kappa, use_fh=use_fh,
                           fh_restrict=fh_restrict))
    vols = {}
    for k in mesh.local:
        y0, y1 = mesh.rows(H, k)
        vols[k] = torch.empty((nspaces * N, y1 - y0, C, L),
                              dtype=torch.float32, device=mesh.devices[k])
    mesh.join(into_ranks=True)   # the inputs and volumes are made
    first = 0
    for g, group in enumerate(groups):
        parts = {k: v[first * N:(first + len(group[1])) * N]
                 for k, v in vols.items()}
        first += len(group[1])
        launches = group_launches(group, sides, R=H, mgm=mgm, kappa=kappa,
                                  fold=g == 0)
        for i, kw in enumerate(launches):
            if group[0] > 0:
                run.stagger(kw, parts, len(sides), accumulate=i > 0)
            else:
                run.lockstep(kw, parts, accumulate=i > 0)
    mesh.join(into_ranks=False)  # the volumes are written
    return {k: (k * rl, v) for k, v in vols.items()}, nspaces


def staggered(mesh, *, flow: int, nb: int, G: int, live, step, ship,
              halo) -> None:
    """A one-way pipeline of nb blocks of G steps over the ranks (K4's
    A/B sub-launches here, K5 on a band in halo.py): rank k runs block
    b at superstep b + q, q its place along `flow` (+1: rank k + 1 is
    downstream), with step[k](b * G) on its stream, where live[k] (its
    (first, last) step with a pixel, None: no row) says it has a pixel
    in it; then block b's track ship[k] (a tensor or tuple of tensors,
    or None: no rank downstream takes it) goes into slot b mod 2 of the
    downstream rank's halo ring halo[k] (the same, 2G entries on axis
    0), which its block b reads next superstep (and block b - 1's in
    the other slot)."""
    n = mesh.size

    def block(k, sigma):
        """Rank k's block at superstep sigma, None where it has no pixel
        in it."""
        if live[k] is None:
            return None
        b = sigma - (k if flow > 0 else n - 1 - k)
        s_lo, s_hi = live[k]
        ok = 0 <= b < nb and b * G <= s_hi and s_lo < (b + 1) * G
        return b if ok else None

    def slot(ring, b):
        parts = tuple(a[b % 2 * G:(b % 2 + 1) * G]
                      for a in (ring if isinstance(ring, tuple) else (ring,)))
        return parts if isinstance(ring, tuple) else parts[0]

    for sigma in range(nb + n - 1):
        for k in step:
            b = block(k, sigma)
            if b is not None:
                with mesh.on(k):
                    step[k](b * G)
        sent = {k: ship[k] if ship[k] is not None
                and block(k, sigma) is not None else None
                for k in mesh.local}
        into = {}
        for k in mesh.local:
            b = block(k - flow, sigma) if 0 <= k - flow < n else None
            into[k] = (None if b is None or halo[k] is None
                       else slot(halo[k], b))
        mesh.shift(sent, flow, into)


def _sub_launch(kw: dict, space: int, ns: int):
    """One space's part of a K1 launch: its planes (sides 0..ns-1), the
    recursions into them and the combos they read, re-indexed; the
    recursions' order (their sum's order) is kept: (planes, mspecs,
    combos), mspecs and combos None when the space has no recursion in
    this launch."""
    lo = space * ns
    planes = kw["planes"][lo:lo + ns]
    mspecs = [ms for ms in kw["mspecs"] if lo <= ms[0] < lo + ns]
    if not mspecs:
        return planes, None, None
    used = []
    for ms in mspecs:
        used += [c for c in ms[1] if c not in used]
    combos = tuple(kw["combos"][c] for c in used)
    mspecs = tuple((ms[0] - lo, tuple(used.index(c) for c in ms[1]),
                    ms[2], ms[3]) for ms in mspecs)
    return planes, mspecs, combos


class _Run:
    """The ranks' inputs, streams and K4's fixed arguments for one
    sharded solve."""

    def __init__(self, mesh, kernel, *, H, C, rl, block, inputs, common):
        self.mesh, self.kernel = mesh, kernel
        self.H, self.C, self.rl, self.G = H, C, rl, block
        self.common = common
        self.inputs = {k: {name: None if a is None else a.to(mesh.devices[k])
                           for name, a in inputs.items()}
                       for k in mesh.local}

    def _state(self, k, D, Ml, rows):
        f32 = dict(dtype=torch.float32, device=self.mesh.devices[k])
        L = self.common["L"]
        return (torch.full((D + 1, Ml, rows, L), INF, **f32),
                torch.full((D + 1, Ml, rows), INF, **f32))

    def _steps(self, kw, planes, k):
        """The scan steps on which band k has a pixel in the space of
        `planes` (one a0 and sign): (first, last), None for a rank
        without a row."""
        slope, fstep = kw["slope"], kw["fstep"]
        a0, ssgn = planes[0][4], planes[0][5]
        r_lo, r_hi = self.mesh.rows(self.H, k)
        if r_lo == r_hi:
            return None
        ends = [a0 - ssgn * slope * r for r in (r_lo, r_hi - 1)]
        t_lo, t_hi = min(ends), max(ends) + fstep * (self.C - 1)
        if kw["reverse"]:
            T = fstep * (self.C - 1) + slope * (self.H - 1) + 1
            return T - 1 - t_hi, T - 1 - t_lo
        return t_lo, t_hi

    def stagger(self, kw, parts, ns: int, *, accumulate: bool):
        """One A/B launch as its per-space staggered sub-launches."""
        mesh, G = self.mesh, self.G
        n = mesh.size
        L = self.common["L"]
        T = kw["fstep"] * (self.C - 1) + kw["slope"] * (self.H - 1) + 1
        nb = -(-T // G)
        for space in range(len(kw["planes"]) // ns):
            planes, mspecs, combos = _sub_launch(kw, space, ns)
            out = {k: p[space * ns:(space + 1) * ns] for k, p in parts.items()}
            if mspecs is None:
                # K1 writes 0 onto a plane without recursions in a
                # launch (0 + kappa*CC with the fold, on the group's
                # first space, which every forward launch holds)
                if any(p[6] for p in planes):
                    raise ValueError("a folded plane without recursions")
                for k, o in out.items():
                    with mesh.on(k):
                        if accumulate:
                            o.add_(0.0)
                        else:
                            o.zero_()
                continue
            rolls = {roll for _, roll in combos} - {0}
            if len(rolls) > 1:
                raise ValueError(f"an A/B sub-launch reads rows above and "
                                 f"below: rolls {sorted(rolls)}")
            down = rolls != {-1}     # reads the row above: flows down
            flow = 1 if down else -1
            D = max(lag for lag, _ in combos)
            Ml = len(mspecs)
            args = dict(self.common, planes=planes, mspecs=mspecs,
                        combos=combos, slope=kw["slope"], fstep=kw["fstep"],
                        reverse=kw["reverse"], accumulate=accumulate, G=G,
                        nsteps=G, ship_row=self.rl - 1 if down else 0,
                        out_off=0)
            halo, ship, step = {}, {}, {}
            live = [self._steps(kw, planes, k) for k in range(n)]
            for k in mesh.local:
                with mesh.on(k):
                    f32 = dict(dtype=torch.float32, device=mesh.devices[k])
                    halo[k] = torch.full((2 * G, Ml, L), INF, **f32)
                    ship[k] = torch.full((G, Ml, L), INF, **f32)
                    if live[k] is None:   # a rank without a row
                        continue
                    hist, mins = self._state(k, D, Ml, self.rl)
                    step[k] = cuda_fused.bind_block(
                        self.kernel, **self.inputs[k], out=out[k],
                        hist=hist, mins=mins, r0=k * self.rl,
                        halo=halo[k], ship=ship[k],
                        share=mesh.sharing(k), **args)
            staggered(mesh, flow=flow, nb=nb, G=G, live=live, step=step,
                      ship=ship, halo=halo)

    def lockstep(self, kw, parts, *, accumulate: bool):
        """One V or parity launch in lockstep blocks over apron-extended
        bands."""
        mesh = self.mesh
        B = min(self.G, self.rl)
        rows = self.rl + 2 * B
        D = max(lag for lag, _ in kw["combos"])
        Ml = len(kw["mspecs"])
        T = kw["fstep"] * (self.C - 1) + kw["slope"] * (self.H - 1) + 1
        args = dict(self.common, planes=kw["planes"], mspecs=kw["mspecs"],
                    combos=kw["combos"], slope=kw["slope"],
                    fstep=kw["fstep"], reverse=kw["reverse"],
                    accumulate=accumulate, G=B, nsteps=B, out_off=B)
        state, step = {}, {}
        for k in mesh.local:
            with mesh.on(k):
                state[k] = self._state(k, D, Ml, rows)
                if parts[k].shape[1]:   # a rank without a row runs none
                    step[k] = cuda_fused.bind_block(
                        self.kernel, **self.inputs[k], out=parts[k],
                        hist=state[k][0], mins=state[k][1],
                        r0=k * self.rl - B, share=mesh.sharing(k), **args)

        def ring_rows(start):
            """Ring rows start .. start + B - 1 of each rank: its hist
            and minima rows, views into the ring."""
            return {k: tuple(a.narrow(2, start, B) for a in state[k])
                    for k in mesh.local}

        # a band's first and last B rows, and its aprons above and below
        first, last = ring_rows(B), ring_rows(self.rl)
        above, below = ring_rows(0), ring_rows(self.rl + B)
        for b in range(-(-T // B)):
            for k in step:
                with mesh.on(k):
                    step[k](b * B)
            # the aprons' ring rows from the neighbours' band rows
            mesh.shift(first, -1, below)
            mesh.shift(last, 1, above)
