"""Generic grid-MRF solver, the mgm_o / MGM_wrapper capability
(counterpart of mgm_tpu/mrf.py).

Approximately minimises
    E(D) = sum_p C(p, D_p) + sum_{pq} w(p,q) * V(D_p, D_q)
on the 4- or 8-connected grid, V = SGM potential (0 / P1 / P2) or the
truncated linear potential min(P1*|a-b|, P2).  Mirrors
matlab/mgm_o.cc:301-606: labels are 0..L-1 for every pixel, edge
weights are 8 planes ordered W, E, S, N, NW, NE, SE, SW, the overcount
fix is always applied.
"""
from __future__ import annotations

import numpy as np
import torch

from .solver import mgm_solve


def solve_mrf(unary: np.ndarray, ndir: int = 8, p1: float = 8.0,
              p2: float = 32.0, mgm: int = 2, vtype: int = 0,
              weights: np.ndarray | None = None, *,
              device="cuda") -> np.ndarray:
    """unary: (H, W, L) cost volume; weights: (H, W, 8) or None.
    Runs on `device` (a torch device or its name) and returns the
    (H, W) float32 labelling (labels 0..L-1)."""
    unary = np.asarray(unary, np.float32)
    H, W, L = unary.shape
    # uploaded in the caller's layout (mrf_cli's is label-major): the
    # device, not the host, makes the canonical copies
    cc = torch.from_numpy(unary).to(device)[None]
    w8 = None
    use_weights = False
    if weights is not None:
        w8 = torch.from_numpy(np.asarray(weights, np.float32)).to(
            device)[None]
        use_weights = bool((w8 != 1.0).any())
    zeros = torch.zeros((1, H, W), dtype=torch.int32, device=cc.device)
    full = torch.full((1, H, W), L - 1, dtype=torch.int32, device=cc.device)
    gmin = torch.zeros((1,), dtype=torch.int32, device=cc.device)
    _, disp, _ = mgm_solve(cc, w8, zeros, full, zeros, full, gmin,
                           p1=float(p1), p2=float(p2), ndir=int(ndir),
                           mgm=int(mgm), use_fh=bool(vtype),
                           use_weights=use_weights, per_pixel=False,
                           fix_overcount=True)
    return disp[0].cpu().numpy()
