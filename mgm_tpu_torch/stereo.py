"""End-to-end stereo pipeline (counterpart of mgm_tpu/stereo.py).

Mirrors main() at mgm.cc:266-450 of gfacciol/mgm for one image pair on
one device: scrub inputs -> P1/P2 *= nch -> adaptive weights ->
prefilter (census, sobelx, gblur) -> cost volume + MGM solve of both
LR sides -> winner-take-all -> subpixel refinement -> (TSGM_ITER:
tighten the windows and solve again) -> median -> LR check both ways
-> backflow.

Two solve branches, chosen as the JAX pipeline's `_fused_backend`
chooses them: NCC costs take the dense branch (the (N, H, W, L) cost
volume, then `solver.mgm_solve` through the K5 kernel, then
subpixel refinement on S); every other cost family takes the fused
branch (`ops/fused.mgm_solve_fused`: costs in flight in K1 for every
pass schedule of 1-16 directions at TSGM 1-4, SGM or FH, weighted or
not, WTA and the subpixel taps in K2 or, under per-pixel windows and
TSGM_ITER, the materialised S assembly, and the knight passes of
ndir > 8 through K8 and K5; refinement from the taps).  Both
branches take per-pixel -m/-M windows, TSGM_ITER (each iteration
solves again with the same recursion windows and tightened S
windows, as the JAX loop does) and the TSGM_DEBUG energy audit.
`compute_disparity_batch` solves K pairs of one shape in one launch
set (K1's and K2's pair axis).  `compute_disparity(mesh=...)` shards
the recursion over the image rows of a parallel.RowMesh: the fused
branch's through K4 (parallel/fused_shard.py, with the knight passes of
ndir > 8 through K8 and K5 on a band), the dense branch's through K5 on
a band (parallel/halo.py: each rank builds its bands' volumes from the
whole images); every rank runs the prep on the whole images, its
band's recursion and the band's WTA, S assembly and refinement, and
the post stages run on the gathered maps, so every output is bitwise
the unsharded run's.  Any H shards: the last ranks' bands may be short
or empty, so no fake rows are padded (mgm_tpu pads them,
mgm_tpu/stereo.py:698-700, and masks them out again).  Not ported: the
wire packing and the OOM re-route (ROADMAP "Not ported").
"""
from __future__ import annotations

import numpy as np
import torch

from .config import MGMConfig
from .ops import post
from .ops.census import census_transform
from .ops.cost import build_cost_volume
from .ops.energy import print_solution_energy
from .ops.fused import mgm_solve_fused
from .ops.prefilter import apply_prefilter
from .ops.refine import subpixel_refine, subpixel_refine_taps
from .ops.weights import compute_weights
from .solver import mgm_solve

# where TSGM_DEBUG writes the energy image: the reference's fixed path
# (mgm_print_energy.h:100-112, mgm_tpu/stereo.py:967)
ENERGY_DUMP = "/tmp/ENERGY_L1trunc.tif"


def _dense(cfg: MGMConfig) -> bool:
    """The dense cost-volume branch (stereo._fused_backend returns None
    for NCC: its per-label box filters stay on the volume path)."""
    return cfg.distance == "ncc"


def _preprocess(img: torch.Tensor, cfg: MGMConfig) -> torch.Tensor:
    """The census words (int32) when the prefilter is census, which
    MGMConfig forces for the census distance; else the prefiltered
    float32 image (mgm_tpu/stereo.py:38-43)."""
    if cfg.prefilter == "census":
        return census_transform(img, cfg.census_ncc_win // 2)
    return apply_prefilter(img, cfg.prefilter)


def _scrub(a: np.ndarray, device) -> torch.Tensor:
    """float32 on `device` with NaN/inf -> 0 (mgm.cc's input scrub)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return torch.nan_to_num(t.to(torch.float32), nan=0.0, posinf=0.0,
                            neginf=0.0)


def _weights(imgs, cfg: MGMConfig):
    """(N, H, W, 8) edge weights of each side's left image, or None when
    all are 1: the reference scans the weight images for any value != 1
    (mgm_core.cc:420-423), and w != 1 needs aP2 != 1."""
    if cfg.a_p2 == 1.0:
        return None
    w8 = torch.stack([compute_weights(a, cfg.a_p2, cfg.a_thresh)
                      for a in imgs])
    return w8 if bool((w8 != 1.0).any()) else None


def _pp_expand(flo_t, fhi_t, *, n_sides: int, gmin_l: int, gmin_r: int,
               dmin: int, dmax: int):
    """The left side's per-pixel float windows and the right side's
    constant ones over the negated global range (mgm.cc:368), as
    stacked (N, H, W) tensors: integer label windows by truncation
    toward zero (Dvec init, dvec.cc:49-60) and the float windows
    TSGM_ITER tightens (mgm_tpu/stereo.py:250-266)."""
    lo = [flo_t.to(torch.int32) - gmin_l]
    hi = [fhi_t.to(torch.int32) - gmin_l]
    flos, fhis = [flo_t], [fhi_t]
    if n_sides == 2:
        lo.append(torch.full_like(lo[0], -dmax - gmin_r))
        hi.append(torch.full_like(hi[0], -dmin - gmin_r))
        flos.append(torch.full_like(flo_t, float(-dmax)))
        fhis.append(torch.full_like(fhi_t, float(-dmin)))
    return (torch.stack(lo), torch.stack(hi), torch.stack(flos),
            torch.stack(fhis))


def _const_windows(H: int, W: int, *, los, his, flos, fhis, device):
    """The constant windows of each side as (N, H, W) tensors: label
    windows (int32) and float windows."""
    def full(vals, dtype):
        return torch.stack([torch.full((H, W), v, dtype=dtype, device=device)
                            for v in vals])
    return (full(los, torch.int32), full(his, torch.int32),
            full(flos, torch.float32), full(fhis, torch.float32))


def _tighten(disp, flo, fhi, gmin, L: int):
    """update_dmin_dmax between iterations -> new float and S windows
    (mgm_tpu/stereo.py:269-276)."""
    flo, fhi, _, _ = post.update_dmin_dmax(disp, flo, fhi)
    g = gmin.to(disp.device)[:, None, None]
    s_lo = (flo.to(torch.int32) - g).clamp(0, L - 1).to(torch.int32)
    s_hi = (fhi.to(torch.int32) - g).clamp(0, L - 1).to(torch.int32)
    return flo, fhi, s_lo, s_hi


def _pixel_windows(dmin_img, dmax_img, cfg: MGMConfig, H: int, W: int,
                   device):
    """The -m/-M float windows (mgm.cc:338-353) as (H, W) float32
    tensors on `device`: non-finite values take the configured range,
    and a window narrower than one label widens to ceil(lo + 1)
    (mgm_tpu/stereo.py:702-710)."""
    if (dmin_img is None) != (dmax_img is None):
        raise ValueError("per-pixel windows need both dmin_img and "
                         "dmax_img")

    def upload(a, fill):
        t = torch.from_numpy(np.asarray(a, np.float32).reshape(H, W))
        return torch.nan_to_num(t.to(device), nan=fill, posinf=fill,
                                neginf=fill)

    flo, fhi = upload(dmin_img, cfg.dmin), upload(dmax_img, cfg.dmax)
    return flo, torch.where(fhi < flo + 1, torch.ceil(flo + 1), fhi)


def compute_disparity(u: np.ndarray, v: np.ndarray, cfg: MGMConfig, *,
                      device="cuda", dmin_img: np.ndarray | None = None,
                      dmax_img: np.ndarray | None = None,
                      outputs: tuple | None = None, mesh=None) -> dict:
    """u, v: (H, W, C) float or uint8 arrays; dmin_img/dmax_img: (H, W)
    per-pixel disparity windows of the left image (-m/-M), or None.
    Runs on `device` (a torch device or its name; the GPU unless the
    caller asks for the CPU) and returns float32 numpy arrays under the
    JAX pipeline's keys: 'disp', 'cost', 'disp_nolr', 'backflow' (left
    side) and 'disp_right', 'cost_right', 'disp_nolr_right' when the LR
    check ran.  `outputs` restricts the returned keys.  With
    cfg.debug, each iteration prints the energy line and writes the
    energy image to ENERGY_DUMP (/tmp/ENERGY_L1trunc.tif), as the
    reference does.  `mesh` (a parallel.RowMesh) shards the recursion
    over the image rows of its ranks, which then run on the mesh's
    devices (`device` is not used): every cost family, ndir 1-16, per-
    pixel windows, TSGM_ITER and TSGM_DEBUG."""
    u = np.asarray(u)
    v = np.asarray(v)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"u and v must be (H, W, C) of one shape, got "
                         f"{u.shape} and {v.shape}")
    if mesh is not None:
        device = mesh.device
    out = _solve(u[None], v[None], cfg, device=device, dmin_img=dmin_img,
                 dmax_img=dmax_img, outputs=outputs, mesh=mesh)
    return {k: a[0] for k, a in out.items()}


def compute_disparity_batch(us, vs, cfg: MGMConfig, *, device="cuda",
                            outputs: tuple = ("disp", "cost")) -> dict:
    """Solve K independent rectified pairs of one shape in ONE set of
    launches: us, vs are (K, H, W, C) stacks sharing one config and
    disparity range; K1 and K2 run the pair as a grid axis, so a batch
    launches as many kernels as one pair.  Returns (K, H, W) float32
    numpy arrays under compute_disparity's keys, restricted to
    `outputs`; each pair's equal to compute_disparity(us[k], vs[k],
    cfg)'s.  NCC, TSGM_ITER > 1 and TSGM_DEBUG take a sequential loop,
    as in the JAX pipeline (mgm_tpu/stereo.py:529-537)."""
    us = np.asarray(us)
    vs = np.asarray(vs)
    if us.ndim != 4 or us.shape != vs.shape:
        raise ValueError(f"us and vs must be (K, H, W, C) of one shape, "
                         f"got {us.shape} and {vs.shape}")
    if _dense(cfg) or cfg.iterations != 1 or cfg.debug:
        outs = [compute_disparity(a, b, cfg, device=device, outputs=outputs)
                for a, b in zip(us, vs)]
        return {key: np.stack([o[key] for o in outs]) for key in outs[0]}
    return _solve(us, vs, cfg, device=device, outputs=outputs)


def _solve(us: np.ndarray, vs: np.ndarray, cfg: MGMConfig, *, device,
           dmin_img=None, dmax_img=None, outputs=None, mesh=None) -> dict:
    """The pipeline on K pairs of one shape, (K, H, W, C) stacks, every
    plane pair-major (pair k's side s is plane k * n_sides + s).  The
    entry points hand per-pixel windows, TSGM_ITER > 1, TSGM_DEBUG and
    NCC over one pair at a time; `mesh` shards the fused recursion of
    one pair (its dense branch's too).  Returns (K, H, W) float32
    arrays."""
    K, H, W, C = us.shape
    n_sides = 2 if cfg.test_lr else 1
    per_pixel = dmin_img is not None or dmax_img is not None
    if per_pixel:
        flo, fhi = _pixel_windows(dmin_img, dmax_img, cfg, H, W, device)
        lo_min = int(flo.to(torch.int32).min())
        hi_max = int(fhi.to(torch.int32).max())
    else:
        lo_min, hi_max = cfg.dmin, cfg.dmax

    # one global label axis for both sides, padded for TSGM_ITER growth;
    # the right solve runs over the negated range (mgm.cc:368,
    # mgm_tpu/stereo.py:726-737)
    pad = 4 * max(cfg.iterations - 1, 0)
    gmin_l, gmax_l = lo_min - pad, hi_max + pad
    gmin_r = -cfg.dmax - pad
    if n_sides == 2:
        L = max(gmax_l - gmin_l, -cfg.dmin + pad - gmin_r) + 1
        gmins = (gmin_l, gmin_r)
    else:
        L = gmax_l - gmin_l + 1
        gmins = (gmin_l,)
    gmin = torch.tensor(gmins * K, dtype=torch.int32)
    p1 = cfg.p1 * C  # scaled by the *original* channel count (mgm.cc:356)
    p2 = cfg.p2 * C

    u_t = _scrub(us, device)
    v_t = _scrub(vs, device)
    dev = u_t.device
    if per_pixel:
        lo_idx, hi_idx, flo_t, fhi_t = _pp_expand(
            flo, fhi, n_sides=n_sides, gmin_l=gmin_l, gmin_r=gmin_r,
            dmin=cfg.dmin, dmax=cfg.dmax)
        # the constant parts of `sides` are placeholders: the windows
        # travel as lo_idx/hi_idx (mgm_tpu/stereo.py:869-873)
        sides = tuple((g, 0, L - 1) for g in gmins)
    else:
        los = (cfg.dmin - gmin_l, -cfg.dmax - gmin_r)[:n_sides]
        his = (cfg.dmax - gmin_l, -cfg.dmin - gmin_r)[:n_sides]
        sides = tuple(zip(gmins, los, his))
        lo_idx, hi_idx, flo_t, fhi_t = _const_windows(
            H, W, los=los * K, his=his * K,
            flos=(cfg.dmin, -cfg.dmax)[:n_sides] * K,
            fhis=(cfg.dmax, -cfg.dmin)[:n_sides] * K, device=dev)
    sides = sides * K

    # weights from the scrubbed, unfiltered images (stereo._prep_core);
    # they count when any of the batch's is not 1
    # (mgm_tpu/stereo.py:605-607)
    w8 = _weights([img for k in range(K)
                   for img in (u_t[k], v_t[k])[:n_sides]], cfg)
    u_p = torch.stack([_preprocess(a, cfg) for a in u_t])
    v_p = torch.stack([_preprocess(a, cfg) for a in v_t])
    dense = _dense(cfg)
    cc = bands = None
    if dense and mesh is not None:
        from .parallel.halo import pair_bands, solve_bands

        # each rank's band volumes, from the whole prepped images
        bands = pair_bands(mesh, u_p[0], v_p[0], lo_idx, hi_idx, gmins,
                           distance=cfg.distance, L=L,
                           trunc_dist=cfg.trunc_dist,
                           ncc_win=cfg.census_ncc_win, w8=w8,
                           fh_restrict=cfg.use_trunc_linear and per_pixel,
                           pids=range(cfg.ndir))
    elif dense:
        # each side's volume written into its slice of the stack
        cc = torch.empty((K * n_sides, H, W, L), dtype=torch.float32,
                         device=dev)
        for n, (k, s) in enumerate(np.ndindex(K, n_sides)):
            build_cost_volume(
                *((u_p[k], v_p[k]) if s == 0 else (v_p[k], u_p[k])),
                lo_idx[n], hi_idx[n], gmins[s], distance=cfg.distance, L=L,
                trunc_dist=cfg.trunc_dist, ncc_win=cfg.census_ncc_win,
                out=cc[n])

    s_lo, s_hi = lo_idx, hi_idx
    for it in range(cfg.iterations):
        if bands is not None:
            # S stays on each rank's band: {rank: (S, disp, cost)}
            S = solve_bands(mesh, H, W, bands, lo_idx, hi_idx, s_lo, s_hi,
                            gmin, p1=p1, p2=p2, ndir=cfg.ndir, mgm=cfg.mgm,
                            use_fh=cfg.use_trunc_linear,
                            use_weights=w8 is not None,
                            fh_restrict=cfg.use_trunc_linear and per_pixel,
                            fix_overcount=cfg.fix_overcount)
            disp, cost = (mesh.gather_rows({k: r[i] for k, r in S.items()},
                                           H) for i in (1, 2))
        elif dense:
            S, disp, cost = mgm_solve(
                cc, w8, lo_idx, hi_idx, s_lo, s_hi, gmin, p1=p1, p2=p2,
                ndir=cfg.ndir, mgm=cfg.mgm, use_fh=cfg.use_trunc_linear,
                use_weights=w8 is not None, per_pixel=per_pixel,
                fix_overcount=cfg.fix_overcount)
        else:
            # constant S windows at the first iteration: K2's WTA
            const_sw = it == 0 and not per_pixel
            S, disp, cost = mgm_solve_fused(
                u_p, v_p, w8, None if const_sw else s_lo,
                None if const_sw else s_hi, sides=sides, L=L,
                ndir=cfg.ndir, mgm=cfg.mgm, p1=p1, p2=p2,
                mode=cfg.distance, trunc_dist=cfg.trunc_dist,
                fix_overcount=cfg.fix_overcount,
                use_fh=cfg.use_trunc_linear,
                want_taps=cfg.refinement != "none",
                lo_px=lo_idx if per_pixel else None,
                hi_px=hi_idx if per_pixel else None, mesh=mesh)
        if cfg.debug:
            # the per-iteration energy audit (TSGM_DEBUG,
            # mgm_print_energy.h) on the left side's dense volume
            cc0 = cc[0] if cc is not None else build_cost_volume(
                u_p[0], v_p[0], lo_idx[0], hi_idx[0], gmins[0],
                distance=cfg.distance, L=L, trunc_dist=cfg.trunc_dist,
                ncc_win=cfg.census_ncc_win)
            print_solution_energy(
                disp[0], cc0, lo_idx[0], hi_idx[0], gmins[0], p1, p2,
                dump_path=ENERGY_DUMP)
            del cc0
        if bands is not None and cfg.refinement != "none":
            disp, cost = _mesh_refine(mesh, S, H, s_lo, s_hi, gmin,
                                      method=cfg.refinement)
        elif cfg.refinement != "none":
            # the fused branch hands the (N, H, 4, W) taps, not S
            refine = subpixel_refine if dense else subpixel_refine_taps
            disp, cost = refine(S, disp, cost, s_lo, s_hi, gmin,
                                method=cfg.refinement)
        del S
        if it + 1 < cfg.iterations:
            flo_t, fhi_t, s_lo, s_hi = _tighten(disp, flo_t, fhi_t, gmin, L)
    del cc, bands, u_p, v_p, w8

    disp = disp_nolr = post.median_filter(disp, radius=cfg.median_radius)
    if n_sides == 2:
        disp = _leftright(disp, cfg.lr_tau)
    left = slice(0, None, n_sides)
    out = {"disp": disp[left], "cost": cost[left],
           "disp_nolr": disp_nolr[left]}
    if outputs is None or "backflow" in outputs:
        out["backflow"] = torch.stack([
            post.backflow(disp[k * n_sides], v_t[k], u_t[k])
            for k in range(K)])
    if n_sides == 2:
        out["disp_right"] = disp[1::2]
        out["cost_right"] = cost[1::2]
        out["disp_nolr_right"] = disp_nolr[1::2]
    if outputs is not None:
        out = {k: a for k, a in out.items() if k in outputs}
    return {k: a.cpu().numpy() for k, a in out.items()}


def _mesh_refine(mesh, res: dict, H: int, s_lo, s_hi, gmin, *, method):
    """Subpixel refinement of each rank's band (solve_bands' results),
    the maps gathered: (disp, cost)."""
    out = {}
    mesh.join(into_ranks=True)   # after the gathers that read res
    for k, (S, disp, cost) in res.items():
        rows = slice(*mesh.rows(H, k))
        dev = mesh.devices[k]
        with mesh.on(k):
            out[k] = subpixel_refine(S, disp, cost, s_lo[:, rows].to(dev),
                                     s_hi[:, rows].to(dev), gmin.to(dev),
                                     method=method)
    mesh.join(into_ranks=False)
    return tuple(mesh.gather_rows({k: r[i] for k, r in out.items()}, H)
                 for i in range(2))


def _leftright(disp, tau: float):
    """The LR check both ways of a pair-major (K * 2, H, W) stack of
    left and right disparities (mgm.cc:68-91)."""
    d_l = post.leftright_test(disp[0::2], disp[1::2], tau)
    d_r = post.leftright_test(disp[1::2], disp[0::2], tau)
    return torch.stack([d_l, d_r], 1).reshape(disp.shape)
