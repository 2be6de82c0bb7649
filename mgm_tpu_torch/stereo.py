"""End-to-end stereo pipeline (counterpart of mgm_tpu/stereo.py).

Mirrors main() at mgm.cc:266-450 of gfacciol/mgm for one image pair on
one device: scrub inputs -> P1/P2 *= nch -> adaptive weights (only
looked at when aP2 != 1) -> fused cost + MGM solve of both LR sides ->
winner-take-all -> median -> LR check both ways -> backflow.

This slice covers constant disparity windows, one iteration, no
prefilter and no subpixel refinement; the rest raises
NotImplementedError naming the ROADMAP item that adds it.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import MGMConfig
from .ops import post
from .ops.fused import mgm_solve_fused
from .ops.weights import compute_weights


def _unsupported(cfg: MGMConfig, per_pixel: bool) -> str | None:
    """Why this slice cannot run `cfg`, or None."""
    if per_pixel:
        return "per-pixel -m/-M windows: ROADMAP queue 1 item 6"
    if cfg.iterations != 1:
        return "TSGM_ITER > 1: ROADMAP queue 1 item 6"
    if cfg.debug:
        return "TSGM_DEBUG energy audit: ROADMAP queue 1 item 6"
    if cfg.refinement != "none":
        return "subpixel refinement: ROADMAP queue 1 item 5"
    if cfg.distance == "ncc":
        return "NCC costs: ROADMAP queue 1 item 7"
    if cfg.prefilter != "none":
        return "prefilters: ROADMAP queue 1 item 2"
    return None


def _scrub(a: np.ndarray, device) -> torch.Tensor:
    """float32 on `device` with NaN/inf -> 0 (mgm.cc's input scrub)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return torch.nan_to_num(t.to(torch.float32), nan=0.0, posinf=0.0,
                            neginf=0.0)


def compute_disparity(u: np.ndarray, v: np.ndarray, cfg: MGMConfig, *,
                      device, dmin_img: np.ndarray | None = None,
                      dmax_img: np.ndarray | None = None,
                      outputs: tuple | None = None) -> dict:
    """u, v: (H, W, C) float or uint8 arrays.  Runs on `device` (a torch
    device or its name) and returns float32 numpy arrays under the JAX
    pipeline's keys: 'disp', 'cost', 'disp_nolr', 'backflow' (left side)
    and 'disp_right', 'cost_right', 'disp_nolr_right' when the LR check
    ran.  `outputs` restricts the returned keys."""
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
    # the reference scans the weight images for any value != 1
    # (mgm_core.cc:420-423); w != 1 needs aP2 != 1
    if cfg.a_p2 != 1.0:
        for img in (u_t, v_t)[:n_sides]:
            if bool((compute_weights(img, cfg.a_p2, cfg.a_thresh)
                     != 1.0).any()):
                raise NotImplementedError("adaptive weights in the fused "
                                          "kernel: ROADMAP queue 1 item 5")

    disp, cost = mgm_solve_fused(
        u_t, v_t, sides=sides, L=L, ndir=cfg.ndir, mgm=cfg.mgm, p1=p1, p2=p2,
        mode=cfg.distance, nch=C, trunc_dist=cfg.trunc_dist,
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
