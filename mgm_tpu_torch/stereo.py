"""End-to-end stereo pipeline (counterpart of mgm_tpu/stereo.py).

Mirrors main() at mgm.cc:266-450 of gfacciol/mgm for one image pair on
one device: scrub inputs -> P1/P2 *= nch -> adaptive weights -> cost
volume + MGM solve of both LR sides -> winner-take-all -> subpixel
refinement -> median -> LR check both ways -> backflow.

Two solve branches, chosen as the JAX pipeline's `_fused_backend`
chooses them: NCC costs take the dense branch (the (N, H, W, L) cost
volume, then `solver.mgm_solve` through the K6/K5/K7 kernels, then
subpixel refinement); every other cost family takes the fused branch
(costs in flight in K1, WTA in K2).  This slice covers constant
disparity windows, one iteration and no prefilter; the rest raises
NotImplementedError naming the ROADMAP item that adds it.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import MGMConfig
from .ops import post
from .ops.cost import build_cost_volume
from .ops.fused import mgm_solve_fused
from .ops.refine import subpixel_refine
from .ops.weights import compute_weights
from .solver import mgm_solve


def _dense(cfg: MGMConfig) -> bool:
    """The dense cost-volume branch (stereo._fused_backend returns None
    for NCC: its per-label box filters stay on the volume path)."""
    return cfg.distance == "ncc"


def _unsupported(cfg: MGMConfig, per_pixel: bool) -> str | None:
    """Why this slice cannot run `cfg`, or None."""
    if per_pixel:
        return "per-pixel -m/-M windows: ROADMAP queue 1 item 6"
    if cfg.iterations != 1:
        return "TSGM_ITER > 1: ROADMAP queue 1 item 6"
    if cfg.debug:
        return "TSGM_DEBUG energy audit: ROADMAP queue 1 item 6"
    if cfg.refinement != "none" and not _dense(cfg):
        return "subpixel refinement in the fused path: ROADMAP queue 1 item 5"
    if cfg.prefilter != "none":
        return "prefilters: ROADMAP queue 1 item 2"
    return None


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


def _solve_dense(u_t, v_t, w8, cfg: MGMConfig, *, sides, L: int,
                 p1: float, p2: float):
    """NCC cost volumes + mgm_solve + refinement for each side (the JAX
    _build_volumes, mgm_solve and _refine); returns (disp, cost), each
    (N, H, W)."""
    H, W, _ = u_t.shape
    dev = u_t.device
    imgs = ((u_t, v_t), (v_t, u_t))[:len(sides)]
    lo = torch.stack([torch.full((H, W), s[1], dtype=torch.int32,
                                 device=dev) for s in sides])
    hi = torch.stack([torch.full((H, W), s[2], dtype=torch.int32,
                                 device=dev) for s in sides])
    gmin = torch.tensor([s[0] for s in sides], dtype=torch.int32,
                        device=dev)
    cc = torch.stack([build_cost_volume(a, b, lo[n], hi[n], sides[n][0],
                                        distance=cfg.distance, L=L,
                                        trunc_dist=cfg.trunc_dist,
                                        ncc_win=cfg.census_ncc_win)
                      for n, (a, b) in enumerate(imgs)])
    S, disp, cost = mgm_solve(
        cc, w8, lo, hi, lo, hi, gmin, p1=p1, p2=p2, ndir=cfg.ndir,
        mgm=cfg.mgm, use_fh=cfg.use_trunc_linear, use_weights=w8 is not None,
        per_pixel=False, fix_overcount=cfg.fix_overcount)
    del cc
    return subpixel_refine(S, disp, cost, lo, hi, gmin,
                           method=cfg.refinement)


def compute_disparity(u: np.ndarray, v: np.ndarray, cfg: MGMConfig, *,
                      device="cuda", dmin_img: np.ndarray | None = None,
                      dmax_img: np.ndarray | None = None,
                      outputs: tuple | None = None) -> dict:
    """u, v: (H, W, C) float or uint8 arrays.  Runs on `device` (a torch
    device or its name; the GPU unless the caller asks for the CPU) and
    returns float32 numpy arrays under the JAX pipeline's keys: 'disp',
    'cost', 'disp_nolr', 'backflow' (left side) and 'disp_right',
    'cost_right', 'disp_nolr_right' when the LR check ran.  `outputs`
    restricts the returned keys."""
    why = _unsupported(cfg, dmin_img is not None or dmax_img is not None)
    if why:
        raise NotImplementedError(why)
    u = np.asarray(u)
    v = np.asarray(v)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"u and v must be (H, W, C) of one shape, got "
                         f"{u.shape} and {v.shape}")
    H, W, C = u.shape
    n_sides = 2 if cfg.test_lr else 1
    # one global label axis for both sides; the right solve runs over the
    # negated range (mgm.cc:368, stereo.py:726-735 of the JAX pipeline)
    L = cfg.dmax - cfg.dmin + 1
    sides = ((cfg.dmin, 0, L - 1), (-cfg.dmax, 0, L - 1))[:n_sides]
    p1 = cfg.p1 * C  # scaled by the *original* channel count (mgm.cc:356)
    p2 = cfg.p2 * C

    u_t = _scrub(u, device)
    v_t = _scrub(v, device)
    w8 = _weights((u_t, v_t)[:n_sides], cfg)
    if _dense(cfg):
        disp, cost = _solve_dense(u_t, v_t, w8, cfg, sides=sides, L=L,
                                  p1=p1, p2=p2)
    else:
        if w8 is not None:
            raise NotImplementedError("adaptive weights in the fused "
                                      "kernel: ROADMAP queue 1 item 5")
        disp, cost = mgm_solve_fused(
            u_t, v_t, sides=sides, L=L, ndir=cfg.ndir, mgm=cfg.mgm, p1=p1,
            p2=p2, mode=cfg.distance, nch=C, trunc_dist=cfg.trunc_dist,
            fix_overcount=cfg.fix_overcount, use_fh=cfg.use_trunc_linear)

    disp = post.median_filter(disp, radius=cfg.median_radius)
    disp_nolr = disp
    if n_sides == 2:
        disp = torch.stack([post.leftright_test(disp[0], disp[1], cfg.lr_tau),
                            post.leftright_test(disp[1], disp[0], cfg.lr_tau)])
    out = {"disp": disp[0], "cost": cost[0], "disp_nolr": disp_nolr[0]}
    if outputs is None or "backflow" in outputs:
        out["backflow"] = post.backflow(disp[0], v_t, u_t)
    if n_sides == 2:
        out["disp_right"] = disp[1]
        out["cost_right"] = cost[1]
        out["disp_nolr_right"] = disp_nolr[1]
    if outputs is not None:
        out = {k: a for k, a in out.items() if k in outputs}
    return {k: a.cpu().numpy() for k, a in out.items()}
