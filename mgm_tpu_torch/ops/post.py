"""Post-processing: NaN-aware median, LR consistency, backflow warp
(mgm.cc:68-91, :432-443 and img_tools.h:203-238; mirror of
mgm_tpu/ops/post.py).

Where the JAX code selects with one-hot sums (a TPU gather workaround),
this module uses torch.gather: exactly one term of each JAX sum is
non-zero, so the results are bitwise equal.
"""
from __future__ import annotations

import torch

from .common import INF, shift_fill


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
