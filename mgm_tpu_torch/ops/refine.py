"""Subpixel refinement (vfit / parabola / cubic / parabolaOCV;
counterpart of mgm_tpu/ops/refine.py).

Vectorised replicas of refine.h, driven as in mgm_refine.h:40-70: a
pixel is refined only if [o-1, o+2] lies inside its S window; the fits
read the *post-overcount-fix* aggregated volume S.  All IEEE corner
cases (NaN guards comparing false, 0/0, inf clamps) follow the C
expressions exactly.  Divisions by a constant are by 2.0, which CUDA's
reciprocal multiply computes exactly, and the square root is the
correctly rounded one (common.sqrt_rn), so CUDA and CPU agree bit for
bit.
"""
from __future__ import annotations

from functools import partial

import torch

from .common import sqrt_rn


def _vfit(v0, v1, v2, v3):
    guard = (v1 > v0) & (v1 > v2)
    slope = torch.where((v2 - v1) < (v0 - v1), v0 - v1, v2 - v1)
    x = (v0 - v2) / (2.0 * slope)
    vm = v2 + (x - 1.0) * slope
    return torch.where(guard, v1, vm), torch.where(guard, 0.0, x)


def _parabola(v0, v1, v2, v3, ocv: bool):
    guard = (v1 > v0) & (v1 > v2)
    c = v1
    b = (v2 - v0) / 2.0
    a = (v2 - 2.0 * v1 + v0) / 2.0
    if ocv:
        a, b = a * 2.0, b * 2.0
        a = torch.where(a > 1.0, a, 1.0)   # NaN -> 1.0, like the C ternary
        x = (-b + a) / (2.0 * a)
    else:
        x = -b / (2.0 * a)
    x = torch.where(x > 1.0, 1.0, x)
    x = torch.where(x < -1.0, -1.0, x)
    vm = (a * x + b) * x + c
    return torch.where(guard, v1, vm), torch.where(guard, 0.0, x)


def _cubic_interp(p0, p1, p2, p3, x):
    return p1 + 0.5 * x * (p2 - p0 + x * (
        2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3 + x * (3.0 * (p1 - p2) + p3 - p0)))


def _cubic(p0, p1, p2, p3):
    take1 = p1 < p2
    pmin = torch.where(take1, p1, p2)
    xmin = torch.where(take1, 0.0, 1.0)
    a = 0.5 * 3.0 * (3.0 * (p1 - p2) + p3 - p0)
    b = 2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3
    c = 0.5 * (p2 - p0)
    discr = b * b - 4.0 * a * c
    sq = sqrt_rn(discr)  # NaN when discr < 0 -> conditions false
    for z in ((-b + sq) / (2.0 * a), (-b - sq) / (2.0 * a)):
        t = _cubic_interp(p0, p1, p2, p3, z)
        upd = (z > 0.0) & (z < 1.0) & (t < pmin)
        pmin = torch.where(upd, t, pmin)
        xmin = torch.where(upd, z, xmin)
    return pmin, xmin


_FITS = {"vfit": _vfit,
         "parabola": partial(_parabola, ocv=False),
         "parabolaOCV": partial(_parabola, ocv=True),
         "cubic": _cubic}


def _label_of(disp, gmin):
    """Integer label of each (N, H, W) disparity."""
    g = gmin.to(disp.device)[:, None, None]
    return (disp - g.to(torch.float32)).to(torch.int32), g


def _finish(o, ok, fit, disp, cost, g):
    vmin, dx = fit
    disp2 = (o + dx).to(torch.float32) + g
    return (torch.where(ok, disp2, disp).to(torch.float32),
            torch.where(ok, vmin, cost).to(torch.float32))


def subpixel_refine_taps(taps, disp, cost, s_lo, s_hi, gmin, *,
                         method: str):
    """Refine from pre-gathered S taps instead of the full volume.

    taps: (N, H, 4, W) holding S[oc-1 .. oc+2] at oc = clip(o, 1, L-3)
    (the JAX fused WTA kernel's want_taps output, or taps_from_S).  The
    `ok` gate ([o-1, o+2] inside the S window, mgm_refine.h:44-49)
    guarantees every consumed tap lies where S is assembled."""
    if method == "none":
        return disp, cost
    o, g = _label_of(disp, gmin)
    ok = (o - 1 >= s_lo) & (o + 2 <= s_hi)
    fit = _FITS[method](taps[:, :, 0], taps[:, :, 1], taps[:, :, 2],
                        taps[:, :, 3])
    return _finish(o, ok, fit, disp, cost, g)


def _gather_taps(S, disp, gmin):
    """(o, g, (N, H, W, 4) S[oc-1 .. oc+2])."""
    L = S.shape[-1]
    o, g = _label_of(disp, gmin)
    oc = o.clamp(1, max(L - 3, 1)).to(torch.int64)
    idx = oc[..., None] + torch.arange(-1, 3, device=S.device)
    return o, g, S.gather(-1, idx.clamp(0, L - 1))


def taps_from_S(S, disp, gmin):
    """The (N, H, 4, W) tap layout gathered from a materialised S."""
    return _gather_taps(S, disp, gmin)[2].movedim(-1, -2)


def subpixel_refine(S, disp, cost, s_lo, s_hi, gmin, *, method: str):
    """S: (N, H, W, L); disp/cost: (N, H, W); gmin: (N,)."""
    if method == "none":
        return disp, cost
    o, g, v = _gather_taps(S, disp, gmin)
    ok = (o - 1 >= s_lo) & (o + 2 <= s_hi)
    fit = _FITS[method](v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    return _finish(o, ok, fit, disp, cost, g)
