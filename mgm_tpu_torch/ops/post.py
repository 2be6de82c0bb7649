"""Post-processing: NaN-aware median, LR consistency, backflow warp and
the TSGM_ITER window update (mgm.cc:68-91, :120-158, :432-443 and
img_tools.h:203-238; mirror of mgm_tpu/ops/post.py).

Where the JAX code selects with one-hot sums (a TPU gather workaround),
this module uses torch.gather: exactly one term of each JAX sum is
non-zero, so the results are bitwise equal.
"""
from __future__ import annotations

import torch

from .common import INF, shift_edge, shift_fill


def median_filter(img: torch.Tensor, *, radius: int) -> torch.Tensor:
    """NaN-aware square median of (..., H, W); windows are clipped at
    image borders, NaNs excluded, median = sorted[n//2] (upper median,
    img_tools.h:203-238).  All-NaN windows keep their value."""
    if radius <= 0:
        return img
    nan = float("nan")
    vals = [shift_fill(shift_fill(img, j, -2, nan), i, -1, nan)
            for j in range(-radius, radius + 1)
            for i in range(-radius, radius + 1)]
    stack = torch.stack(vals, -1)
    finite = ~torch.isnan(stack)
    n = finite.sum(-1)
    svals = torch.where(finite, stack, INF).sort(-1).values
    med = svals.gather(-1, (n // 2).clamp(max=stack.shape[-1] - 1)[..., None])
    return torch.where(n > 0, med[..., 0], img)


def leftright_test(d_left: torch.Tensor, d_right: torch.Tensor,
                   tau: float) -> torch.Tensor:
    """Invalidate (NaN) left disparities failing the LR check
    (mgm.cc:68-91).  If the reprojected right disparity is NaN the
    comparison |Rx-x| > tau is false and the pixel *survives*, exactly
    like the C code."""
    W = d_left.shape[-1]
    x = torch.arange(W, dtype=torch.float32, device=d_left.device)
    # C round() = half away from zero
    t = x + d_left
    lx = torch.sign(t) * torch.floor(t.abs() + 0.5)
    ok = (lx >= 0) & (lx < W)  # NaN compares false
    lxi = torch.nan_to_num(lx, nan=0.0).clamp(0, W - 1).to(torch.int64)
    rdx = d_right.gather(-1, lxi)
    rx = lx + rdx
    tau32 = torch.tensor(tau, dtype=torch.float32, device=d_left.device)
    bad = (rx - x).abs() > tau32
    return torch.where(ok & ~bad, d_left, float("nan"))


def update_dmin_dmax(disp: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     *, slack: int = 3, radius: int = 2):
    """Per-pixel disparity range tightening between iterations
    (mgm.cc:120-158): window min/max of the previous solution +- slack
    with clamp-to-edge windows; non-finite pixels contribute the global
    finite min/max.  disp, lo, hi: (..., H, W) float32.  Returns float
    (lo2, hi2, gmin, gmax), gmin/gmax keeping the (..., 1, 1) axes."""
    finite = torch.isfinite(disp)
    any_finite = finite.any(-1, keepdim=True).any(-2, keepdim=True)
    gmin = torch.where(finite, disp, INF).amin((-2, -1), keepdim=True)
    gmax = torch.where(finite, disp, -INF).amax((-2, -1), keepdim=True)
    a_lo = torch.where(finite, disp, gmin)
    a_hi = torch.where(finite, disp, gmax)
    for axis in (-2, -1):
        mn, mx = a_lo, a_hi
        for s in range(1, radius + 1):
            mn = torch.minimum(mn, torch.minimum(shift_edge(a_lo, s, axis),
                                                 shift_edge(a_lo, -s, axis)))
            mx = torch.maximum(mx, torch.maximum(shift_edge(a_hi, s, axis),
                                                 shift_edge(a_hi, -s, axis)))
        a_lo, a_hi = mn, mx
    lo2 = a_lo - slack
    hi2 = a_hi + slack
    upd = torch.isfinite(lo2) & any_finite
    return (torch.where(upd, lo2, lo), torch.where(upd, hi2, hi), gmin,
            gmax)


def backflow(disp: torch.Tensor, v: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """Backprojected right image (mgm.cc:432-443): syn(p) = v(x+d, y)
    with float->index truncation (= floor since x+d >= 0 inside the
    image), else the left pixel.  disp (H, W); u, v (H, W, C)."""
    W, C = u.shape[1], u.shape[2]
    x = torch.arange(W, dtype=torch.float32, device=disp.device)[None, :]
    t = x + disp
    inside = (t >= 0) & (t < W)  # NaN -> False
    qx = torch.floor(torch.nan_to_num(t, nan=0.0)).clamp(0, W - 1)
    qx = qx.to(torch.int64)
    vg = v.gather(1, qx[..., None].expand(-1, -1, C))
    return torch.where(inside[..., None], vg, u)
