"""Energy diagnostics of TSGM_DEBUG (mgm_print_energy.h:17-112 of
gfacciol/mgm; mirror of mgm_tpu/ops/energy.py).

Recomputes E(D) = sum_p C_p(D_p) + pairwise terms over the 4-connected
grid under three pairwise models:
  type 0: truncated-L1  (P1 if |Dp-Dq| <= 1 else P2, averaged over dirs)
  type 1: L1            |Dp-Dq| / 4
  type 2: L2            sqrt((Dr-Dp)^2 + (Dq-Dp)^2) / 4 over direction
                        pairs (r, q = next direction CCW)
Faithful quirks: a pairwise term only counts when BOTH pr and pq (the
L2 pair) are inside the image; the per-pixel energy image returned for
type 0 stores the *L1* contribution (mgm_print_energy.h:80, `Etrunc
[pidx] = G`); a non-finite or out-of-window disparity contributes +inf
through the data term (Dvec out-of-range read).  Plain tensor code:
the square root is the correctly rounded one (common.sqrt_rn), so the
per-pixel images agree bit for bit between the CPU and the GPU and
only the totals' summation order differs.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import INF, shift_fill, sqrt_rn

# directions[] at mgm_print_energy.h:51-53: W, S, E, N (+ wrap W)
DIRS = ((-1, 0), (0, 1), (1, 0), (0, -1))


def _neighbor(disp, dx, dy):
    """disp value at (x+dx, y+dy); NaN outside the image."""
    nan = float("nan")
    return shift_fill(shift_fill(disp, -dy, -2, nan), -dx, -1, nan)


def _inside_mask(H, W, dx, dy, device):
    y = torch.arange(H, device=device)[:, None] + dy
    x = torch.arange(W, device=device)[None, :] + dx
    return (y >= 0) & (y < H) & (x >= 0) & (x < W)


def evaluate_energy_4connected(disp, cc, lo, hi, gmin: int, *, p1: float,
                               p2: float, etype: int = 0):
    """disp: (H, W) float32 disparities; cc: (H, W, L) dense cost volume
    (+inf outside windows); lo/hi: (H, W) int32 label windows; gmin:
    disparity of label 0.  Returns (total_energy, per_pixel_image), a
    0-dim and an (H, W) float32 tensor."""
    H, W, L = cc.shape
    dev = disp.device
    f32 = dict(dtype=torch.float32, device=dev)
    # data term: CC[p][o] converts the RAW float disparity to int
    # (truncation toward zero, mgm_print_energy.h:46 + dvec.cc:129)
    # *before* the window-min offset is applied
    bad = float(np.float32(gmin) - np.float32(1.0))
    di = torch.nan_to_num(disp, nan=bad, posinf=bad,
                          neginf=bad).to(torch.int32)
    oi = di - int(gmin)
    in_rng = (torch.isfinite(disp) & (oi >= lo) & (oi <= hi) & (oi >= 0)
              & (oi < L))
    data = torch.where(
        in_rng,
        cc.gather(-1, oi.clamp(0, L - 1).to(torch.int64)[..., None])[..., 0],
        INF)

    g_l1 = g_l2 = g_tr = data
    n = torch.tensor(float(len(DIRS)), **f32)
    p1n, p2n = torch.tensor(p1, **f32) / n, torch.tensor(p2, **f32) / n
    for t in range(4):
        dr = _neighbor(disp, *DIRS[t])
        dq = _neighbor(disp, *DIRS[(t + 1) % 4])
        # both pr and pq must be inside the image; NaN *disparities*
        # still count, so use explicit inside masks, not value tests
        both = (_inside_mask(H, W, *DIRS[t], dev)
                & _inside_mask(H, W, *DIRS[(t + 1) % 4], dev))
        a, b = dr - disp, dq - disp
        l1 = a.abs() / n
        l2 = sqrt_rn(a * a + b * b) / n
        tr = torch.where(a.abs() <= 1.0, p1n, p2n)
        g_l1 = g_l1 + torch.where(both, l1, 0.0)
        g_l2 = g_l2 + torch.where(both, l2, 0.0)
        g_tr = g_tr + torch.where(both, tr, 0.0)

    if etype == 1:
        return g_l1.sum(), g_l1
    if etype == 2:
        return g_l2.sum(), g_l2
    # type 0: total is truncated-L1 but the image is the L1 map
    return g_tr.sum(), g_l1


def print_solution_energy(disp, cc, lo, hi, gmin: int, p1: float, p2: float,
                          debug: bool = True, dump_path: str | None = None):
    """Replicates print_solution_energy (mgm_print_energy.h:100-112):
    prints the three energies and writes the type-0 image to
    `dump_path`.  Returns the three energies as floats."""
    if not debug:
        print()
        return None
    e = [evaluate_energy_4connected(disp, cc, lo, hi, gmin, p1=p1, p2=p2,
                                    etype=k) for k in range(3)]
    e0, e1, e2 = (float(x[0]) for x in e)
    print(f" ENERGY L1trunc: {e0:.9e}\tL1: {e1:.9e}\tL2: {e2:.9e}")
    if dump_path is not None:
        from ..io import write_image
        write_image(dump_path, e[0][1].cpu().numpy())
    return e0, e1, e2
