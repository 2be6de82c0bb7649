"""One MGM solve on dense volumes: aggregation + S assembly + WTA
(counterpart of mgm_tpu/solver.py).

Mirrors mgm() at mgm_core.cc:408-613 with dense (N, H, W, L) arrays:
  - the recursion runs on the CC label windows (Lr is a copy of CC);
  - S accumulates Lr only over CC-window cells that fall inside the
    (possibly tighter) S windows (increment_nolock clips), else stays 0;
  - the overcount fix S[o] -= (NDIR-1)*CC[o] mutates S *before* the
    argmin and before subpixel refinement reads it, including the
    -inf/NaN cells the reference produces where S and CC windows
    disagree (mgm_core.cc:592-609);
  - WTA takes the first finite minimum in ascending label order.
"""
from __future__ import annotations

import torch

from .ops.aggregate import aggregate
from .ops.common import INF
from .ops.cost import window_mask


def mgm_solve(cc, w8, lo, hi, s_lo, s_hi, gmin, *, p1: float, p2: float,
              ndir: int, mgm: int, use_fh: bool, use_weights: bool,
              per_pixel: bool, fix_overcount: bool):
    """Returns (S, disp, cost).

    cc: (N, H, W, L) dense cost volume (+inf outside [lo, hi] windows)
    lo/hi: recursion (CC) label windows; s_lo/s_hi: S/WTA windows
    gmin: (N,) disparity value of label index 0 per problem
    S: the post-overcount-fix aggregated volume (what refinement reads);
       cells outside the S windows hold +inf.
    disp: float disparities (label argmin + gmin); cost: the minima.
    """
    L = cc.shape[-1]
    lsum = aggregate(cc, w8, lo, hi, p1=p1, p2=p2, ndir=ndir, mgm=mgm,
                     use_fh=use_fh, use_weights=use_weights,
                     fh_restrict=use_fh and per_pixel)
    in_cc = window_mask(lo, hi, L)
    in_s = window_mask(s_lo, s_hi, L)
    s_raw = torch.where(in_cc, lsum, 0.0)
    del lsum
    if fix_overcount:
        cc_inf = torch.where(in_cc, cc, INF)
        kappa = torch.tensor(float(ndir - 1), dtype=torch.float32,
                             device=cc.device)
        s_raw = s_raw - kappa * cc_inf
        del cc_inf
    S = torch.where(in_s, s_raw, INF)
    del s_raw
    cand = torch.where(torch.isfinite(S), S, INF)
    idx = cand.argmin(-1)   # the first minimal label, as jnp.argmin
    cost = cand.amin(-1)
    disp = (gmin.to(cc.device)[:, None, None] + idx).to(torch.float32)
    return S, disp, cost
