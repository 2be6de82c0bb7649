"""Fused-path scheduling and the single-device fused solve (counterpart
of mgm_tpu/ops/fused.py).

The scheduling (`PASS_DIRS`, `SCHEDULES`, `_assign`, `fused_spec`,
`split_passes`) is a line-for-line mirror of the JAX module: a pass
runs in the fused cost + wavefront kernel iff its first `mgm` causal
deps are strictly causal under a forward or backward scan of skew space
A (t = c + slope*r) or B (t = c + slope*(R-1-r)); antipodal passes land
in one space with opposite scan directions, so the backward launch
accumulates onto the forward launch's planes.

`mgm_solve_fused` ports the A/B-group, fused-WTA case of the JAX solve
(fused.py:582-597): constant label windows, SGM potential, unit
weights, ad/sd costs.  The V and packed-parity spaces, the dense
leftover passes and every other option raise NotImplementedError and
name the ROADMAP item that adds them.
"""
from __future__ import annotations

import torch

from . import cuda_fused

# image-space causal dirs dir1..dir4 per pass (mgm_core.cc:463-471);
# (dx, dy) with dy the row offset
PASS_DIRS = (
    ((-1, 0), (0, -1), (-1, -1), (1, -1)),
    ((1, 0), (0, 1), (1, 1), (-1, 1)),
    ((0, 1), (-1, 0), (-1, 1), (-1, -1)),
    ((0, -1), (1, 0), (1, -1), (1, 1)),
    ((-1, -1), (1, -1), (0, -1), (1, 0)),
    ((1, -1), (1, 1), (1, 0), (0, 1)),
    ((1, 1), (-1, 1), (0, 1), (-1, 0)),
    ((-1, 1), (-1, -1), (-1, 0), (0, -1)),
)

# Space V = slope-0 column fronts (t = c, no skew): passes whose
# coupled deps are all strictly horizontal-causal (|dx| = 1, any dy)
# run as plain left-to-right / right-to-left column scans — this is
# what makes passes 5 and 7 (deps all with dx = +1 / -1 up to mgm = 3,
# mgm_core.cc:468,471) fusable, so ndir = 8 configs at mgm <= 3 (the
# reference's census/trunc-linear benchmarks) never touch the
# cost-volume fallback.
#
# Spaces PA/PB = slope-1/2 ("parity") wavefronts t = 2c + r (PA) /
# t = 2c + (R-1-r) (PB): the only linear schedules under which the
# mgm = 4 dep sets of passes 2/3/5/7 (each mixing a vertical dep with
# both diagonal signs, mgm_core.cc:465-471) are strictly causal —
# pass 2 fwd / 3 bwd in PB, pass 7 fwd / 5 bwd in PA.  Each front
# holds every other image row; the kernel PACKS lanes as half-rows
# (lane rho = row 2*rho + front-parity), so occupancy stays full and
# only the front count grows (T = 2C + R vs C + 2R).  This removes the
# last dense-volume fallback of the reference's default TSGM=4 config.
SCHEDULES = (("A", "fwd"), ("A", "bwd"), ("B", "fwd"), ("B", "bwd"),
             ("V", "fwd"), ("V", "bwd"),
             ("PA", "fwd"), ("PA", "bwd"), ("PB", "fwd"), ("PB", "bwd"))

P_SLOPE = -1  # `slope` tag marking the packed parity group


def _assign(p: int, mgm: int, slope: int):
    """(space, dir, ranks) scheduling pass p's first `mgm` deps, or
    None.  ranks: per-dep (front lag, lane roll) — parity spaces use
    (front lag, dy) since the packed lane roll is front-parity
    dependent (pallas_fused._delta_roll).  Preference order keeps
    low-mgm configs in space A (fewer planes) and reaches for V and
    the parity spaces (extra launch pairs) last."""
    if p >= len(PASS_DIRS):
        return None  # knight passes stay on the cost-volume path
    deps = PASS_DIRS[p][:mgm]
    for space, d in SCHEDULES:
        ranks = []
        for dx, dy in deps:
            if space == "A":
                dt = dx + slope * dy
            elif space == "B":
                dt = dx - slope * dy
            elif space == "V":
                dt = dx
            elif space == "PA":
                dt = 2 * dx + dy
            else:
                dt = 2 * dx - dy
            lag = -dt if d == "fwd" else dt
            if lag <= 0:
                break
            ranks.append((lag, dy) if space in ("PA", "PB")
                         else (lag, -dy))
        else:
            return space, d, tuple(ranks)
    return None


def fused_spec(p: int, mgm: int):
    """Fusability at full (slope 2) coverage; None -> cost-volume path."""
    return _assign(p, mgm, 2)


def split_passes(ndir: int, mgm: int):
    """(groups, leftover_pids).

    groups: up to three (slope, spaces, launches) tuples — the skewed
    group (slope 1 or 2, spaces within {A, B}), the column-front group
    (slope 0, ["V"]) and the packed parity group (slope P_SLOPE = -1,
    spaces within {PA, PB}); launches within a group:
    [("fwd", [(pid, space, ranks, border), ...]), ("bwd", [...])] with
    empty directions dropped; border = (need_left, need_right,
    need_top, need_bottom) from the pass's FULL 4-dep set
    (mgm_core.cc:538-541).  Slope 1 is preferred when it covers the
    same pass set (no skewed dep with |dt| == 0), shrinking the skewed
    arrays ~30%.
    """
    cand = {p: fused_spec(p, mgm) for p in range(ndir)}
    fused = {p for p, s in cand.items() if s is not None}
    in_ab = {p for p in fused if cand[p][0] in ("A", "B")}
    cand1 = {p: _assign(p, mgm, 1) for p in in_ab}
    if in_ab and all(a is not None and a[0] in ("A", "B")
                     for a in cand1.values()):
        cand.update(cand1)
        slope = 1
    else:
        slope = 2
    leftover = [p for p in range(ndir) if p not in fused]
    groups = []
    for kind in ("AB", "V", "P"):
        launches = {"fwd": [], "bwd": []}
        spaces = []
        for p in sorted(fused):
            space, d, ranks = cand[p]
            k = "V" if space == "V" else ("P" if space in ("PA", "PB")
                                          else "AB")
            if k != kind:
                continue
            full = PASS_DIRS[p]
            border = (any(dx < 0 for dx, dy in full),
                      any(dx > 0 for dx, dy in full),
                      any(dy < 0 for dx, dy in full),
                      any(dy > 0 for dx, dy in full))
            launches[d].append((p, space, ranks, border))
            if space not in spaces:
                spaces.append(space)
        if spaces:
            order = {"AB": ("A", "B"), "V": ("V",), "P": ("PA", "PB")}
            spaces = [s for s in order[kind] if s in spaces]
            gslope = {"AB": slope, "V": 0, "P": P_SLOPE}[kind]
            groups.append((gslope, spaces,
                           [(d, ms) for d, ms in launches.items() if ms]))
    return groups, leftover


def _ab_group(ndir: int, mgm: int):
    """The one skewed A/B group scheduling every pass of (ndir, mgm);
    NotImplementedError when a pass needs another space or the dense
    path."""
    groups, leftover = split_passes(ndir, mgm)
    if leftover:
        raise NotImplementedError(f"passes {leftover} need the dense "
                                  "cost-volume path: ROADMAP queue 1 item 7")
    if len(groups) != 1 or groups[0][0] <= 0:
        raise NotImplementedError("the V and packed-parity spaces: ROADMAP "
                                  "queue 1 item 5")
    return groups[0]


def ab_launches(group, sides, *, R: int, kappa: float):
    """Per-launch kernel arguments of one skewed A/B group
    (fused.py:333-431): planes, mspecs, combos, slope and reverse.

    group: (slope, spaces, launches) from split_passes; sides: (gmin, lo,
    hi) per side.  planes = (side, gmin, lo, hi, a0, ssgn, fold),
    space-major; the overcount fold kappa*CC sits on each side's
    first-space plane, in the first launch only."""
    slope, spaces, launches = group
    a0 = {"A": 0, "B": slope * (R - 1)}
    ssgn = {"A": -1, "B": 1}
    plane_ix, planes = {}, []
    for space in spaces:
        for n, (gmin, lo, hi) in enumerate(sides):
            plane_ix[(n, space)] = len(planes)
            fold = space == spaces[0] and kappa != 0.0
            planes.append((n, gmin, lo, hi, a0[space], ssgn[space], fold))
    out = []
    for k, (d, passes) in enumerate(launches):
        combos = []
        for _, _, ranks, _ in passes:
            combos += [c for c in ranks if c not in combos]
        mspecs = tuple((plane_ix[(n, space)],
                        tuple(combos.index(c) for c in ranks), border)
                       for _, space, ranks, border in passes
                       for n in range(len(sides)))
        lp = tuple(planes) if k == 0 else tuple(p[:6] + (False,)
                                                for p in planes)
        out.append(dict(planes=lp, mspecs=mspecs, combos=tuple(combos),
                        slope=slope, reverse=d == "bwd"))
    return out


def fused_planes(lefts, rights, *, sides, L: int, ndir: int, mgm: int,
                 p1: float, p2: float, mode: str, tmax: float, kappa: float,
                 wavefront=None):
    """Every launch of the A/B group through `wavefront`: K1
    (cuda_fused.fused_wavefront) when None; tests and the smoke run pass
    its plain version to compare.

    lefts/rights: (N, R, C, nch) float32 images per side.  Returns the
    (nspaces * N, R, C, L) volume and nspaces."""
    group = _ab_group(ndir, mgm)
    wavefront = wavefront or cuda_fused.fused_wavefront
    out = None
    for kw in ab_launches(group, sides, R=lefts.shape[1], kappa=kappa):
        out = wavefront(lefts, rights, out, L=L, mgm=mgm, mode=mode,
                        tmax=tmax, p1=p1, p2=p2, kappa=kappa, **kw)
    return out, len(group[1])


def mgm_solve_fused(u_p: torch.Tensor, v_p: torch.Tensor, *, sides, L: int,
                    ndir: int, mgm: int, p1: float, p2: float, mode: str,
                    nch: int, trunc_dist: float, fix_overcount: bool,
                    use_fh: bool = False):
    """One MGM solve from preprocessed (H, W, Cch) float32 images, costs
    fused into the recursion, straight to the winner-take-all (the JAX
    solve's want_S=False, const_sw=True branch).  Side n >= 1 (the LR
    check's right solve) swaps the images.

    sides: (gmin, lo, hi) ints per side.  Returns (disp, cost), each
    (N, H, W) float32 on the images' device."""
    if u_p.ndim != 3:
        raise NotImplementedError("batched pairs: ROADMAP queue 1 item 8")
    if use_fh:
        raise NotImplementedError("the truncated-linear potential in the "
                                  "fused kernel: ROADMAP queue 1 item 5")
    if mode not in ("ad", "sd"):
        raise NotImplementedError(f"in-flight {mode!r} costs: ROADMAP "
                                  "queue 1 item 5")
    N = len(sides)
    lefts = torch.stack([u_p, v_p][:N]).contiguous()
    rights = torch.stack([v_p, u_p][:N]).contiguous()
    vol, nspaces = fused_planes(
        lefts, rights, sides=sides, L=L, ndir=ndir, mgm=mgm, p1=p1, p2=p2,
        mode=mode, tmax=trunc_dist * nch,
        kappa=-float(ndir - 1) if fix_overcount else 0.0)
    return cuda_fused.wta(vol, nspaces=nspaces, sides=sides)
