"""MGM directional aggregation on dense volumes (counterpart of
mgm_tpu/ops/aggregate.py).

After flipping/transposing each pass into its canonical scan
orientation, every pass has causal neighbours inside {W, N, NW, NE} of
scan space (plus WWN for the 22.5-degree knight passes), so one
canonical wavefront kernel serves all 16 directions, and the passes of
a group (and the left/right problems) are batched into one scan.

This is the JAX module's accelerator path (`_run_group_pallas`): each
homogeneous pass group is canonicalised with tensor ops, skewed (K6),
scanned (K5), unskewed (K7), mapped back and summed.  The TPU's VMEM
chunking (`pick_block`, the HBM cap) is not ported: a group runs as one
scan.  The kernels and their plain versions live in ops/wavefront.py,
with the SGM and FH messages.

Dense semantics: +inf outside a pixel's label window reproduces the
Dvec out-of-range convention (dvec.cc:129) exactly, including the
1-pixel border that never aggregates (mgm_core.cc:538-541) and the
per-pixel cached minima.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import wavefront as wf
from .common import INF


@dataclass(frozen=True)
class PassSpec:
    row_major: bool
    flip_x: bool        # inc_x == 0 in the reference table
    flip_y: bool        # inc_y == 0
    diag: bool          # 45-degree pass: canonical dir order is reversed
    wch: tuple          # weight channels for dir1..dir4 (mgm_core.cc:481-484)
    knight: bool = False  # 22.5-degree pass (main dir a knight move)


# Canonicalised reference pass table (mgm_core.cc:463-471), extended
# with the eight 22.5-degree passes the reference advertises via -O 16
# but crashes on (its table stops at 8, mgm_core.cc:473-474,489).
# Knight passes use canonical causal dirs (dir1..dir4) =
# [(-2,-1), (0,-1), (-1,-1), (-1,0)] of scan space; weight channels are
# the 8-neighbour channel with the same sign pattern (the weight image
# has no 22.5-degree planes).
PASS_TABLE = (
    PassSpec(True, False, False, False, (0, 3, 4, 5)),   # W->E
    PassSpec(True, True, True, False, (1, 2, 6, 7)),     # E->W
    PassSpec(False, False, True, False, (2, 0, 7, 4)),   # S->N scan of columns
    PassSpec(False, True, False, False, (3, 1, 5, 6)),   # N->S scan of columns
    PassSpec(True, True, False, True, (4, 5, 3, 1)),     # diag NW
    PassSpec(False, True, True, True, (5, 6, 1, 2)),     # diag NE
    PassSpec(True, False, True, True, (6, 7, 2, 0)),     # diag SE
    PassSpec(False, False, False, True, (7, 4, 0, 3)),   # diag SW
    PassSpec(True, False, False, False, (4, 3, 4, 0), True),   # (-2,-1)
    PassSpec(True, True, True, False, (6, 2, 6, 1), True),     # (2,1)
    PassSpec(True, True, False, False, (5, 3, 5, 1), True),    # (2,-1)
    PassSpec(True, False, True, False, (7, 2, 7, 0), True),    # (-2,1)
    PassSpec(False, False, False, False, (4, 0, 4, 3), True),  # (-1,-2)
    PassSpec(False, True, True, False, (6, 1, 6, 2), True),    # (1,2)
    PassSpec(False, True, False, False, (5, 1, 5, 3), True),   # (1,-2)
    PassSpec(False, False, True, False, (7, 0, 7, 2), True),   # (-1,2)
)

# stack order of the canonical causal offsets
#   W   = (ii-1, jj)   N  = (ii, jj-1)   NW = (ii-1, jj-1)
#   NE  = (ii+1, jj-1) WWN = (ii-2, jj-1)   (knight passes)
AXIS_DIR2OFF = (0, 1, 2, 3)     # dir k -> offset index, axis passes
DIAG_DIR2OFF = (3, 2, 1, 0)     # dir k -> offset index, diagonal passes
KNIGHT_DIR2OFF = (4, 1, 2, 0)   # dir k -> offset index, knight passes


def to_canonical(a, spec: PassSpec, h_axis: int, w_axis: int):
    if spec.flip_x:
        a = torch.flip(a, (w_axis,))
    if spec.flip_y:
        a = torch.flip(a, (h_axis,))
    if not spec.row_major:
        a = a.transpose(h_axis, w_axis)
    return a


def from_canonical(a, spec: PassSpec, h_axis: int, w_axis: int):
    if not spec.row_major:
        a = a.transpose(h_axis, w_axis)
    if spec.flip_y:
        a = torch.flip(a, (h_axis,))
    if spec.flip_x:
        a = torch.flip(a, (w_axis,))
    return a


def _dir2off(spec: PassSpec):
    if spec.knight:
        return KNIGHT_DIR2OFF
    return DIAG_DIR2OFF if spec.diag else AXIS_DIR2OFF


def _pass_groups(ndir: int, mgm: int, pids=None):
    """Group the first `ndir` passes into homogeneous batched scans (the
    JAX module's homogeneous=True, what its accelerator path runs): same
    canonical shape (row_major) and same class, so the dir->offset order
    is static.  Knight passes group apart (their offset set and border
    differ).  `pids` restricts grouping to those passes (the fused
    solve's leftovers)."""
    groups = {}
    for p in (range(ndir) if pids is None else pids):
        spec = PASS_TABLE[p]
        key = (spec.row_major, "knight" if spec.knight else spec.diag)
        groups.setdefault(key, []).append(p)
    return list(groups.values())


@dataclass(frozen=True)
class GroupPlan:
    """One homogeneous pass group's scan geometry."""
    specs: tuple
    R: int              # canonical rows
    C: int              # canonical columns
    slope: int          # 1 unless the NE offset is active
    dir2off: tuple      # offset id per coupled dir
    offs: tuple         # active offset ids, ascending (the ranks)
    knight: bool


def group_plan(pids, H: int, W: int, mgm: int) -> GroupPlan:
    specs = tuple(PASS_TABLE[p] for p in pids)
    d2o = tuple(_dir2off(specs[0])[:mgm])
    offs = tuple(sorted(set(d2o)))
    R, C = (H, W) if specs[0].row_major else (W, H)
    # slope-1 wavefronts whenever NE (same-front on slope 1) is inactive
    slope = 2 if 3 in offs else 1
    return GroupPlan(specs, R, C, slope, d2o, offs, specs[0].knight)


def canonical_inputs(plan: GroupPlan, cc, w8, lo, hi, *, use_weights,
                     fh_restrict):
    """The group's canonical, pass-stacked inputs for K6:
    cc (B*N, R, C, L); weights (n_off*B*N, R, C, 1), offset-rank outer
    (or None); lo/hi (B*N, R, C, 1) int32 (or None)."""
    specs = plan.specs
    N = cc.shape[0]
    R, C = plan.R, plan.C
    cc_c = torch.stack([to_canonical(cc, s, 1, 2) for s in specs])
    cc_c = cc_c.reshape(len(specs) * N, R, C, cc.shape[-1])
    w_c = lo_c = hi_c = None
    if use_weights:
        wmaps = []
        for s in specs:
            # channel per offset rank: offset o is dir k with d2o[k] == o
            chs = [s.wch[plan.dir2off.index(o)] for o in plan.offs]
            wmaps.append(torch.stack([to_canonical(w8[..., c], s, 1, 2)
                                      for c in chs]))   # (n_off, N, R, C)
        w_c = torch.stack(wmaps, 1).reshape(-1, R, C, 1)
    if fh_restrict:
        lo_c = torch.stack([to_canonical(lo, s, 1, 2) for s in specs])
        hi_c = torch.stack([to_canonical(hi, s, 1, 2) for s in specs])
        lo_c = lo_c.reshape(-1, R, C, 1).to(torch.int32)
        hi_c = hi_c.reshape(-1, R, C, 1).to(torch.int32)
    return cc_c.contiguous(), w_c, lo_c, hi_c


# skew fill of the canonical inputs: costs, weights, lo, hi (an empty
# window outside the image, aggregate.py:450-458 of the JAX module)
FILLS = (INF, 1.0, 0, -1)


def skewed_inputs(canon, slope: int, skew=None):
    """canonical_inputs' tensors through `skew` (K6 when None; tests and
    the smoke run pass its plain version); None stays None."""
    skew = skew or wf.skew
    return tuple(None if x is None else skew(x, fill, slope)
                 for x, fill in zip(canon, FILLS))


def scan_kwargs(plan: GroupPlan, *, p1, p2, mgm, use_fh, use_weights,
                fh_restrict) -> dict:
    """K5's keyword arguments for the group."""
    return dict(C=plan.C, p1=p1, p2=p2, mgm=mgm, dir2off=plan.dir2off,
                slope=plan.slope, knight=plan.knight, use_fh=use_fh,
                use_weights=use_weights, fh_restrict=fh_restrict)


def _run_group(pids, cc, w8, lo, hi, *, p1, p2, mgm, use_fh, use_weights,
               fh_restrict):
    """One homogeneous pass group through K6 -> K5 -> K7 (the JAX
    _run_group_pallas, aggregate.py:390-470).  cc: (N, H, W, L); returns
    the sum over the group's passes of their aggregated volumes."""
    N, H, W, L = cc.shape
    plan = group_plan(pids, H, W, mgm)
    lr_sk, w_sk, lo_sk, hi_sk = skewed_inputs(
        canonical_inputs(plan, cc, w8, lo, hi, use_weights=use_weights,
                         fh_restrict=fh_restrict), plan.slope)
    wf.wavefront_scan(lr_sk, w_sk, lo_sk, hi_sk, **scan_kwargs(
        plan, p1=p1, p2=p2, mgm=mgm, use_fh=use_fh, use_weights=use_weights,
        fh_restrict=fh_restrict))
    del w_sk, lo_sk, hi_sk
    lr = wf.unskew(lr_sk, plan.C, plan.slope)
    del lr_sk
    lr = lr.reshape(len(pids), N, plan.R, plan.C, L)
    out = from_canonical(lr[0], plan.specs[0], 1, 2)
    for b in range(1, len(pids)):
        out = out + from_canonical(lr[b], plan.specs[b], 1, 2)
    return out


def aggregate(cc, w8=None, lo=None, hi=None, *, p1: float, p2: float,
              ndir: int, mgm: int, use_fh: bool = False,
              use_weights: bool = False, fh_restrict: bool = False,
              pids: tuple | None = None, hpad: int = 0):
    """Sum over the first `ndir` directional passes (or over `pids`) of
    the aggregated volumes Lr (before the S-window clip / overcount
    fix, which the solver applies).

    cc: (N, H, W, L) dense costs with +inf outside label windows.
    w8: (N, H, W, 8) edge weights (channel order W,E,S,N,NW,NE,SE,SW,
        mgm_weights.h:69) when use_weights.
    lo/hi: (N, H, W) int32 label windows, needed when fh_restrict
        (truncated-linear potential with per-pixel windows).
    hpad: mesh padding rows, which only the JAX package's XLA backend
        takes; must be 0 here.
    """
    if hpad:
        raise NotImplementedError("hpad (mesh padding rows): row sharding "
                                  "is ROADMAP queue 1 item 10")
    if fh_restrict:
        # the MGM==2 unweighted FH path uses the boundary-fixed full-axis
        # min-conv instead of the window-restricted one (mgm_core.cc:208)
        fh_restrict = not ((mgm == 2) and (not use_weights))
    out = None
    for gp in _pass_groups(ndir, mgm, pids):
        part = _run_group(gp, cc, w8, lo, hi, p1=p1, p2=p2, mgm=mgm,
                          use_fh=use_fh, use_weights=use_weights,
                          fh_restrict=fh_restrict)
        out = part if out is None else out + part
    return out
