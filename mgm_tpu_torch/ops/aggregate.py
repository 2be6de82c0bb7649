"""MGM directional aggregation on dense volumes (counterpart of
mgm_tpu/ops/aggregate.py).

In its canonical scan orientation (the image flipped and transposed as
the pass says) every pass has causal neighbours inside {W, N, NW, NE}
of scan space (plus WWN for the 22.5-degree knight passes), so one
canonical wavefront kernel serves all 16 directions, and the passes of
a group (and the left/right problems) are batched into one scan.

This is the JAX module's accelerator path (`_run_group_pallas`), with
its layout work absorbed into K5's addressing: K5 reads each pass's
costs, weights and label windows from the image-layout tensors through
the pass's orientation map (`pass_map`: canonical pixel (r, c) is image
pixel origin + r*dr + c*dc) and writes each pass's aggregated volume in
image orientation, so no canonical, skewed or unskewed copy is made
(the TPU's K6 skew and K7 unskew have no launch of their own); the
passes are then summed.  The TPU's VMEM chunking (`pick_block`, the HBM
cap) is not ported: a group runs as one scan.  The kernel and its plain
version live in ops/wavefront.py, with the SGM and FH messages.

Dense semantics: +inf outside a pixel's label window reproduces the
Dvec out-of-range convention (dvec.cc:129) exactly, including the
1-pixel border that never aggregates (mgm_core.cc:538-541) and the
per-pixel cached minima.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import wavefront as wf


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
    """The pass's canonical scan orientation of `a` (the definition that
    pass_map encodes; the tests hold the map to it)."""
    if spec.flip_x:
        a = torch.flip(a, (w_axis,))
    if spec.flip_y:
        a = torch.flip(a, (h_axis,))
    if not spec.row_major:
        a = a.transpose(h_axis, w_axis)
    return a


def from_canonical(a, spec: PassSpec, h_axis: int, w_axis: int):
    """The inverse of to_canonical."""
    if not spec.row_major:
        a = a.transpose(h_axis, w_axis)
    if spec.flip_y:
        a = torch.flip(a, (h_axis,))
    if spec.flip_x:
        a = torch.flip(a, (w_axis,))
    return a


def pass_map(spec: PassSpec, H: int, W: int) -> tuple[int, int, int]:
    """(origin, dr, dc): canonical pixel (r, c) of the pass is image
    pixel y*W + x = origin + r*dr + c*dc of an H x W image, the
    addressing of to_canonical (row-major passes step columns by +-1 and
    rows by +-W, column-major passes the other way round; a flip starts
    at the far edge and steps back)."""
    y0, sy = (H - 1, -W) if spec.flip_y else (0, W)
    x0, sx = (W - 1, -1) if spec.flip_x else (0, 1)
    return (y0 * W + x0,) + ((sy, sx) if spec.row_major else (sx, sy))


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
    maps: tuple         # pass_map of each pass
    wch: tuple          # each pass's weight channel of each offset rank


def group_plan(pids, H: int, W: int, mgm: int) -> GroupPlan:
    specs = tuple(PASS_TABLE[p] for p in pids)
    d2o = tuple(_dir2off(specs[0])[:mgm])
    offs = tuple(sorted(set(d2o)))
    R, C = (H, W) if specs[0].row_major else (W, H)
    # slope-1 wavefronts whenever NE (same-front on slope 1) is inactive
    slope = 2 if 3 in offs else 1
    # offset o couples dir k with d2o[k] == o: its weight is the pass's
    # channel of that dir
    wch = tuple(tuple(s.wch[d2o.index(o)] for o in offs) for s in specs)
    return GroupPlan(specs, R, C, slope, d2o, offs, specs[0].knight,
                     tuple(pass_map(s, H, W) for s in specs), wch)


def _pad_geometry(spec: PassSpec, hpad: int, R: int, C: int):
    """Where `hpad` fake rows appended at the image bottom land in this
    pass's canonical space, as shifted border-mask bounds (the JAX
    module's _pad_geometry, aggregate.py:209-225).

    Pads at the canonical BOTTOM are never read (all canonical deps
    point to the same row or the row above), so only flip_y passes need
    a shift: row-major passes get them at the canonical top (row0),
    col-major passes at the canonical left (col0) — flip_y=False
    col-major passes get them at the canonical right (C1 shrinks).
    Returns (row0, col0, C1): the first real canonical row, first real
    canonical column, and real column count."""
    if not hpad:
        return 0, 0, C
    if spec.row_major:
        return (hpad if spec.flip_y else 0), 0, C
    return 0, (hpad if spec.flip_y else 0), C - hpad


def scan_kwargs(plan: GroupPlan, *, p1, p2, mgm, use_fh, use_weights,
                fh_restrict, hpad: int = 0) -> dict:
    """K5's keyword arguments for the group (`hpad` fake bottom rows:
    each pass's shifted border, _pad_geometry)."""
    return dict(R=plan.R, C=plan.C, maps=plan.maps, wch=plan.wch, p1=p1,
                p2=p2, mgm=mgm, dir2off=plan.dir2off, slope=plan.slope,
                knight=plan.knight, use_fh=use_fh, use_weights=use_weights,
                fh_restrict=fh_restrict,
                border=tuple(_pad_geometry(s, hpad, plan.R, plan.C)
                             for s in plan.specs) if hpad else None)


def sum_passes(out):
    """out[0] + out[1] + ... left to right: a group's passes summed in
    the order of the JAX module's pass loop."""
    acc = out[0]
    for b in range(1, out.shape[0]):
        acc = acc + out[b]
    return acc


def _run_group(pids, cc, w8, lo, hi, *, p1, p2, mgm, use_fh, use_weights,
               fh_restrict, hpad):
    """One homogeneous pass group through K5 (the JAX _run_group_pallas,
    aggregate.py:390-470) on the image-layout inputs.  cc: (N, H, W, L);
    returns the sum over the group's passes of their aggregated
    volumes."""
    plan = group_plan(pids, cc.shape[1], cc.shape[2], mgm)
    return sum_passes(wf.wavefront_scan(cc, w8, lo, hi, **scan_kwargs(
        plan, p1=p1, p2=p2, mgm=mgm, use_fh=use_fh, use_weights=use_weights,
        fh_restrict=fh_restrict, hpad=hpad)))


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
    hpad: trailing fake image rows appended so a device mesh divides H
        (the JAX module's hpad); real border pixels behave exactly as at
        the true image edge and never read pad cells (K5's shifted
        border, _pad_geometry).
    """
    if fh_restrict:
        # the MGM==2 unweighted FH path uses the boundary-fixed full-axis
        # min-conv instead of the window-restricted one (mgm_core.cc:208)
        fh_restrict = not ((mgm == 2) and (not use_weights))
    # K5 reads contiguous image-layout inputs: one copy here when the
    # caller's layout differs (mrf_cli's label-major unary), not one a
    # pass
    cc = cc.contiguous()
    w8 = w8.contiguous() if use_weights else None
    if fh_restrict:
        lo, hi = (x.to(torch.int32).contiguous() for x in (lo, hi))
    out = None
    for gp in _pass_groups(ndir, mgm, pids):
        part = _run_group(gp, cc, w8, lo, hi, p1=p1, p2=p2, mgm=mgm,
                          use_fh=use_fh, use_weights=use_weights,
                          fh_restrict=fh_restrict, hpad=hpad)
        out = part if out is None else out + part
    return out
