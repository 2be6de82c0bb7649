"""Fused-path scheduling and the single-device fused solve (counterpart
of mgm_tpu/ops/fused.py).

The scheduling (`PASS_DIRS`, `SCHEDULES`, `_assign`, `fused_spec`,
`split_passes`) is a line-for-line mirror of the JAX module: a pass
runs in the fused cost + wavefront kernel iff its first `mgm` causal
deps are strictly causal under a forward or backward scan of skew space
A (t = c + slope*r) or B (t = c + slope*(R-1-r)); antipodal passes land
in one space with opposite scan directions, so the backward launch
accumulates onto the forward launch's planes.

`mgm_solve_fused` ports the JAX solve (fused.py:512-672) for every
schedule of `split_passes` (ndir 1-16, TSGM 1-4): every pointwise cost
family in flight (ad, sd, census words, btad/btsd blocks), the SGM or
truncated-linear (FH) potential, optional edge weights, constant or
per-pixel (-m/-M) label windows, TSGM_ITER's tightened S windows, and a
batch of K image pairs (K1's and K2's pair axis).  Every group (A/B,
V, PA/PB) runs through K1 into one image-layout volume with the spaces
in the order A, B, V, PA, PB.  With constant windows and no leftover
passes K2 sums the spaces and takes the WTA (and the subpixel taps).
Otherwise the sum is materialised: with leftover passes (ndir > 8) the
knight passes run dense (K8 builds the cost volumes, `aggregate` runs
K5 on them), and the S assembly, WTA and taps are tensor code.
The TPU's K3 (`pallas_fused.unskew_planes`) has no counterpart: K1
already stores the image layout, so the assembled sum has nothing to
unskew.
"""
from __future__ import annotations

import torch

from ..solver import window_wta
from . import cuda_fused
from .aggregate import PASS_TABLE, aggregate
from .cost import _bt_aux, build_cost_volume, window_mask
from .refine import taps_from_S

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


def _space_map(space: str, slope: int, R: int):
    """K1's front map of `space` in a group of `slope` (cuda_fused's
    module docstring): (slope, fstep, a0, ssgn)."""
    return {"A": (slope, 1, 0, -1), "B": (slope, 1, slope * (R - 1), 1),
            "V": (0, 1, 0, -1), "PA": (1, 2, 0, -1),
            "PB": (1, 2, R - 1, 1)}[space]


def group_launches(group, sides, *, R: int, mgm: int, kappa: float,
                   fold: bool):
    """Per-launch K1 arguments of one group of split_passes
    (fused.py:333-431): planes, mspecs, combos, slope, fstep and
    reverse.  A recursion's weight channels are its pass's
    PASS_TABLE wch, one per coupled dep (fused.py:407-420).

    group: (slope, spaces, launches); sides: (gmin, lo, hi) per side.
    planes = (side, gmin, lo, hi, a0, ssgn, fold), space-major.  With
    `fold`, the overcount kappa*CC sits on each side's first-space
    plane, in the first launch only.  The parity spaces' ranks are
    (lag, dy) (`_assign`); K1 reads the row r - roll, so they become
    (lag, -dy), the other spaces' form."""
    gslope, spaces, launches = group
    maps = {sp: _space_map(sp, gslope, R) for sp in spaces}
    plane_ix, planes = {}, []
    for space in spaces:
        _, _, a0, ssgn = maps[space]
        for n, (gmin, lo, hi) in enumerate(sides):
            plane_ix[(n, space)] = len(planes)
            f = fold and space == spaces[0] and kappa != 0.0
            planes.append((n, gmin, lo, hi, a0, ssgn, f))
    slope, fstep = maps[spaces[0]][:2]
    out = []
    for k, (d, passes) in enumerate(launches):
        recs = []
        for pid, space, ranks, border in passes:
            if fstep == 2:
                ranks = tuple((lag, -dy) for lag, dy in ranks)
            recs.append((space, ranks, border, PASS_TABLE[pid].wch[:mgm]))
        combos = []
        for _, ranks, _, _ in recs:
            combos += [c for c in ranks if c not in combos]
        mspecs = tuple((plane_ix[(n, space)],
                        tuple(combos.index(c) for c in ranks), border, wch)
                       for space, ranks, border, wch in recs
                       for n in range(len(sides)))
        lp = tuple(planes) if k == 0 else tuple(p[:6] + (False,)
                                                for p in planes)
        out.append(dict(planes=lp, mspecs=mspecs, combos=tuple(combos),
                        slope=slope, fstep=fstep, reverse=d == "bwd"))
    return out


def fused_planes(lefts, rights, *, sides, L: int, groups, mgm: int,
                 p1: float, p2: float, mode: str, tmax: float, kappa: float,
                 use_fh: bool = False, w8=None, lo_px=None, hi_px=None,
                 fh_restrict: bool = False, npair: int = 1, wavefront=None):
    """Every launch of `groups` (from split_passes) through `wavefront`:
    K1 (cuda_fused.fused_wavefront) when None; tests and the smoke run
    pass its plain version to compare.  The first group folds kappa*CC
    (JAX's fold_group, fused.py:456-464).

    lefts/rights: (N, R, C, nch) images per side as K1 takes them
    (float32, int32 census words, or BT's [I, Imin, Imax] blocks), N =
    npair * len(sides), pair-major; sides: (gmin, lo, hi) per side of
    one pair; w8: (N, R, C, 8) edge weights or None; lo_px/hi_px:
    (N, R, C) int32 per-pixel label windows or None, fh_restrict
    masking the FH messages' input with them.  Returns the
    (nspaces * N, R, C, L) volume, spaces in the order A, B, V, PA, PB
    (each group's launches write one contiguous slice of planes), and
    nspaces."""
    wavefront = wavefront or cuda_fused.fused_wavefront
    N, R, C, _ = lefts.shape
    nspaces = sum(len(spaces) for _, spaces, _ in groups)
    vol = torch.empty((nspaces * N, R, C, L), dtype=torch.float32,
                      device=lefts.device)
    first = 0
    for g, group in enumerate(groups):
        part = vol[first * N:(first + len(group[1])) * N]
        first += len(group[1])
        for k, kw in enumerate(group_launches(group, sides, R=R, mgm=mgm,
                                              kappa=kappa, fold=g == 0)):
            wavefront(lefts, rights, part, accumulate=k > 0, L=L, mgm=mgm,
                      mode=mode, tmax=tmax, p1=p1, p2=p2, kappa=kappa,
                      use_fh=use_fh, w8=w8, lo_px=lo_px, hi_px=hi_px,
                      fh_restrict=fh_restrict, npair=npair, **kw)
    return vol, nspaces


def assemble_groups(vol, *, nspaces: int, N: int):
    """The materialised per-side sum (N, R, C, L) of the spaces, left to
    right (((A + B) + V) + PA) + PB, the association order of K2 and of
    the JAX assembly (fused.py:471-505).  K1 stores the image layout, so
    no unskew (the TPU's K3) is needed."""
    total = vol[:N]
    for si in range(1, nspaces):
        total = total + vol[si * N:(si + 1) * N]
    return total


def assemble_swta(lsum, s_lo=None, s_hi=None, *, sides, L: int, ndir: int,
                  fix_overcount: bool, lo_px=None, hi_px=None):
    """S assembly + WTA from the fold-included sum of the aggregated
    volumes (fused.py:675-702).  The CC window is each side's constant
    one (`sides`) or, with lo_px/hi_px, each pixel's; the S window is
    s_lo/s_hi ((N, H, W) int32), or the CC window when None.  Returns
    (S, disp, cost)."""
    if lo_px is not None:
        in_cc = window_mask(lo_px, hi_px, L)       # (N, H, W, L)
    else:
        lab = torch.arange(L, device=lsum.device)
        in_cc = torch.stack([(lab >= lo) & (lab <= hi)
                             for _, lo, hi in sides])[:, None, None, :]
    # 0 - (NDIR-1)*INFINITY outside the CC window, as the dense solver
    # computes it: -inf, or NaN (0 * inf) at ndir 1
    if fix_overcount:
        outside = -float("inf") if ndir > 1 else float("nan")
    else:
        outside = 0.0
    s_raw = torch.where(in_cc, lsum, outside)
    in_s = in_cc if s_lo is None else window_mask(s_lo, s_hi, L)
    gmin = torch.tensor([g for g, _, _ in sides], dtype=torch.int32)
    return window_wta(s_raw, in_s, gmin)


def side_images(ups, vps, *, nsides: int, mode: str):
    """(lefts, rights): the left and right image of each side of each
    pair (side 1 swaps them), (npair * nsides, H, W, nch) pair-major, as
    K1 takes them: BT's [I, Imin, Imax] blocks, built once an image
    (fused.py:560-562), the others as they are.  ups/vps:
    (npair, H, W, nch) stacks."""
    if mode in ("btad", "btsd"):
        ups, vps = (torch.cat([a, *_bt_aux_batch(a)], -1) for a in (ups, vps))
    pairs = torch.stack([ups, vps], 1)        # (npair, 2, H, W, nch)
    lefts = pairs[:, :nsides]
    rights = pairs.flip(1)[:, :nsides]
    return (lefts.flatten(0, 1).contiguous(),
            rights.flatten(0, 1).contiguous())


def _bt_aux_batch(a):
    """_bt_aux of every image of an (npair, H, W, nch) stack."""
    aux = [_bt_aux(x) for x in a]
    return tuple(torch.stack([x[j] for x in aux]) for j in range(2))


def _dense_cc(ups, vps, *, sides, L: int, mode: str, trunc_dist: float,
              lo_px=None, hi_px=None):
    """(N, H, W, L) dense cost volumes of each side of each pair
    (through K8, one launch a side, each writing its slice of the
    stack), for the leftover passes (fused.py:621-639), from the
    (npair, H, W, nch) preprocessed images (build_cost_volume makes BT's
    blocks itself), over each side's constant window or each pixel's
    (lo_px/hi_px, (N, H, W))."""
    _, H, W, _ = ups.shape
    full = dict(dtype=torch.int32, device=ups.device)
    ns = len(sides)
    out = torch.empty((ups.shape[0] * ns, H, W, L), dtype=torch.float32,
                      device=ups.device)
    for n in range(out.shape[0]):
        k, sd = divmod(n, ns)
        gmin, lo, hi = sides[sd]
        a, b = (ups[k], vps[k]) if sd == 0 else (vps[k], ups[k])
        if lo_px is not None:
            lo_a, hi_a = lo_px[n], hi_px[n]
        else:
            lo_a, hi_a = torch.full((H, W), lo, **full), torch.full(
                (H, W), hi, **full)
        build_cost_volume(a, b, lo_a, hi_a, gmin, distance=mode, L=L,
                          trunc_dist=trunc_dist, out=out[n])
    return out


def mgm_solve_fused(u_p: torch.Tensor, v_p: torch.Tensor, w8=None,
                    s_lo=None, s_hi=None, *, sides, L: int, ndir: int,
                    mgm: int, p1: float, p2: float, mode: str,
                    trunc_dist: float, fix_overcount: bool,
                    use_fh: bool = False, want_taps: bool = False,
                    lo_px=None, hi_px=None, mesh=None):
    """One MGM solve from preprocessed images, costs fused into the
    recursion (the JAX solve with want_S False or "taps").  Side 1 of a
    pair (the LR check's right solve) swaps the images.

    u_p, v_p: (H, W, nch) float32 images (int32 census words for mode
      "census"), or (K, H, W, nch) stacks of K pairs, solved in one
      launch set (K1's pair axis).  Costs truncate at trunc_dist * nch
      with nch = u_p.shape[-1] (the census word count), before BT's
      [I, Imin, Imax] blocks are built.
    w8: (N, H, W, 8) float32 edge weights of each side, or None.
    sides: (gmin, lo, hi) ints per side, N = K * n_sides entries,
      pair-major, every pair's the same (JAX's batched layout).
    s_lo/s_hi: (N, H, W) int32 S/WTA windows (TSGM_ITER tightens
      them), or None: the CC windows.
    lo_px/hi_px: (N, H, W) int32 per-pixel recursion windows (-m/-M),
      or None: the constant windows of `sides`.
    With constant windows (s_lo and lo_px None) and no leftover passes
    the spaces go straight to K2's WTA (and taps); otherwise the sum is
    materialised (K1 folds kappa*CC when there are no leftover passes),
    the knight passes are added from the dense path, S is assembled
    and the taps gathered from it (fused.py:566-672).
    mesh: a parallel.RowMesh: the recursion runs row-sharded through
      K4 (parallel/fused_shard.py; one pair, no leftover passes), each
      rank's band takes the same tail (K2, or the S assembly) on its
      rows, and disp, cost and taps are gathered to the mesh's device.
    Returns (taps, disp, cost): disp and cost (N, H, W) float32 on the
    images' device, taps (N, H, 4, W) with `want_taps`, else None."""
    ups, vps = (u_p, v_p) if u_p.ndim == 4 else (u_p[None], v_p[None])
    npair = ups.shape[0]
    N = len(sides)
    ns = N // npair
    pair_sides = tuple(sides[:ns])
    if ns < 1 or tuple(sides) != pair_sides * npair:
        raise ValueError(f"sides: {npair} pairs need one table of sides "
                         f"repeated pair by pair, got {sides}")
    tmax = trunc_dist * ups.shape[-1]
    lefts, rights = side_images(ups, vps, nsides=ns, mode=mode)
    if w8 is not None:
        w8 = w8.contiguous()
    groups, leftover = split_passes(ndir, mgm)
    kappa = -float(ndir - 1) if fix_overcount else 0.0
    per_pixel = lo_px is not None
    if per_pixel:
        lo_px, hi_px = lo_px.contiguous(), hi_px.contiguous()
    use_weights = w8 is not None
    # K1's FH window restriction follows aggregate()'s rule: mgm 2
    # unweighted uses the full-axis min-conv (fused.py:571-572)
    fh_restrict = (use_fh and per_pixel
                   and not (mgm == 2 and not use_weights))
    # with leftover passes the overcount folds on the dense volume
    # (fused.py:619, 647)
    kw = dict(sides=pair_sides, L=L, groups=groups, mgm=mgm, p1=p1, p2=p2,
              mode=mode, tmax=tmax, kappa=0.0 if leftover else kappa,
              use_fh=use_fh, w8=w8, lo_px=lo_px, hi_px=hi_px,
              fh_restrict=fh_restrict)
    tail = dict(N=N, pair_sides=pair_sides, sides=sides, L=L, ndir=ndir,
                mgm=mgm, p1=p1, p2=p2, mode=mode, trunc_dist=trunc_dist,
                kappa=kappa, fix_overcount=fix_overcount, use_fh=use_fh,
                want_taps=want_taps, s_lo=s_lo, s_hi=s_hi, lo_px=lo_px,
                hi_px=hi_px)
    if mesh is None:
        vol, nspaces = fused_planes(lefts, rights, npair=npair, **kw)
        del lefts, rights
        return _solve_tail(vol, 0, nspaces=nspaces, npair=npair, ups=ups,
                           vps=vps, w8=w8, leftover=leftover, **tail)
    from ..parallel.fused_shard import sharded_fused_planes

    if npair != 1:
        raise ValueError("row sharding of the fused branch takes one pair "
                         "(mgm_tpu's rule)")
    bands, nspaces = sharded_fused_planes(lefts, rights, mesh=mesh, **kw)
    del lefts, rights
    parts = _mesh_leftover(mesh, ups[0], vps[0], w8, leftover, **tail)
    H, W = ups.shape[1:3]
    res = {}
    for k, (r0, vol) in bands.items():
        if not vol.shape[1]:   # a rank without a row
            empty = dict(dtype=torch.float32, device=vol.device)
            res[k] = (torch.empty((N, 0, 4, W), **empty) if want_taps
                      else None, torch.empty((N, 0, W), **empty),
                      torch.empty((N, 0, W), **empty))
            continue
        res[k] = _solve_tail(vol, r0, nspaces=nspaces, npair=1,
                             leftover=leftover, part=parts.get(k), **tail)
    del bands, parts
    return tuple(None if res[mesh.local[0]][i] is None
                 else mesh.gather_rows({k: r[i] for k, r in res.items()}, H)
                 for i in range(3))


def _mesh_leftover(mesh, u, v, w8, leftover, *, pair_sides, L, ndir, mgm,
                   p1, p2, mode, trunc_dist, kappa, fix_overcount, use_fh,
                   lo_px, hi_px, **_) -> dict:
    """The leftover (knight) passes of one pair over the mesh, as
    _solve_tail adds them on one device: each rank's band volumes of the
    pair's sides through K8 (halo.pair_bands), K5 on the bands
    (halo.aggregate_bands), plus kappa * CC with the overcount fix;
    {local rank: (N, h, W, L) on its band of rows}, or {} without
    leftover passes."""
    if not leftover:
        return {}
    from ..parallel.halo import aggregate_bands, pair_bands

    H, W = u.shape[:2]
    per_pixel = lo_px is not None
    if not per_pixel:
        full = dict(dtype=torch.int32, device=u.device)
        lo_px, hi_px = (torch.stack([torch.full((H, W), side[j], **full)
                                     for side in pair_sides])
                        for j in (1, 2))
    bands = pair_bands(mesh, u, v, lo_px, hi_px,
                       [g for g, _, _ in pair_sides], distance=mode, L=L,
                       trunc_dist=trunc_dist, w8=w8,
                       fh_restrict=use_fh and per_pixel, pids=leftover)
    parts = aggregate_bands(mesh, H, W, bands, p1=p1, p2=p2, ndir=ndir,
                            mgm=mgm, use_fh=use_fh,
                            use_weights=w8 is not None,
                            fh_restrict=use_fh and per_pixel,
                            pids=tuple(leftover))
    if fix_overcount:
        for k in parts:
            parts[k] = parts[k] + kappa * bands[k]["row"][0]
    return parts


def _solve_tail(vol, r0: int, *, nspaces: int, N: int, npair: int,
                pair_sides, sides, L: int, ndir: int, mgm: int, p1: float,
                p2: float, mode: str, trunc_dist: float, kappa: float,
                fix_overcount: bool, use_fh: bool, want_taps: bool,
                s_lo=None, s_hi=None, lo_px=None, hi_px=None, ups=None,
                vps=None, w8=None, leftover=(), part=None):
    """mgm_solve_fused after K1 (or K4) on the rows r0 .. r0 + h - 1 of
    the (nspaces * N, h, W, L) volume: K2, or the materialised sum with
    the leftover passes and the S assembly.  The leftover passes' sum
    (with kappa * CC) is `part` on those rows (a mesh rank's, from
    _mesh_leftover), or made here from the whole images ups/vps, w8.
    The windows s_lo/s_hi, lo_px/hi_px hold every image row.  Returns
    (taps, disp, cost) of those rows."""
    rows = slice(r0, r0 + vol.shape[1])

    def band(a):
        return None if a is None else a[:, rows]

    per_pixel = lo_px is not None
    if not leftover and s_lo is None and not per_pixel:
        res = cuda_fused.wta(vol, nspaces=nspaces, sides=pair_sides,
                             npair=npair, want_taps=want_taps)
        return (res[2] if want_taps else None,) + res[:2]
    s_lo, s_hi = band(s_lo), band(s_hi)
    lsum = assemble_groups(vol, nspaces=nspaces, N=N)
    del vol
    if leftover and part is None:
        cc = _dense_cc(ups, vps, sides=pair_sides, L=L, mode=mode,
                       trunc_dist=trunc_dist, lo_px=lo_px, hi_px=hi_px)
        part = aggregate(cc, w8, lo_px, hi_px, p1=p1, p2=p2, ndir=ndir,
                         mgm=mgm, use_fh=use_fh,
                         use_weights=w8 is not None,
                         fh_restrict=use_fh and per_pixel,
                         pids=tuple(leftover))
        if fix_overcount:
            part = part + kappa * cc
        del cc
    if leftover:
        lsum = lsum + part
        del part
    S, disp, cost = assemble_swta(lsum, s_lo, s_hi, sides=sides, L=L,
                                  ndir=ndir, fix_overcount=fix_overcount,
                                  lo_px=band(lo_px), hi_px=band(hi_px))
    if not want_taps:
        return None, disp, cost
    gmin = torch.tensor([g for g, _, _ in sides], dtype=torch.int32)
    return taps_from_S(S, disp, gmin), disp, cost
