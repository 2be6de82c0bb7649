"""Shared tensor helpers (mirror of mgm_tpu/ops/common.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

INF = float("inf")


def _pad_axis(a: torch.Tensor, axis: int, before: int, after: int,
              **kw) -> torch.Tensor:
    """F.pad along one axis (F.pad lists pads from the last axis back)."""
    axis = axis % a.ndim
    pad = [0, 0] * (a.ndim - axis - 1) + [before, after]
    return F.pad(a, pad, **kw)


def shift_fill(a: torch.Tensor, off: int, axis: int, fill) -> torch.Tensor:
    """Return b with b[i] = a[i - off] along `axis`; vacated slots = fill.

    This reproduces the reference's Dvec/image boundary convention where
    out-of-range reads yield +inf (dvec.cc:129) or another fill value.
    """
    if off == 0:
        return a
    n = a.shape[axis]
    if off > 0:
        return _pad_axis(a, axis, off, 0, value=fill).narrow(axis, 0, n)
    return _pad_axis(a, axis, 0, -off, value=fill).narrow(axis, -off, n)


def shift_edge(a: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """Shift with clamp-to-edge (Neumann) boundary (img_tools.h:76-84)."""
    if off == 0:
        return a
    n = a.shape[axis]
    idx = torch.arange(n, device=a.device) - off
    return a.index_select(axis, idx.clamp(0, n - 1))


def pad_cols(a: torch.Tensor, gmin: int, L: int):
    """Edge-pad the columns of (H, W, C) so every disparity
    d = gmin..gmin+L-1 becomes the slice a_pad[:, x + d - gmin + left];
    returns (a_pad, left).  Out-of-image labels are masked to trunc_dist
    by build_cost_volume."""
    W = a.shape[1]
    left = max(0, -gmin)
    right = max(0, gmin + L - 1)
    idx = torch.arange(-left, W + right, device=a.device).clamp(0, W - 1)
    return a.index_select(1, idx), left


def shifted_cols(a_pad, left: int, gmin: int, l: int, W: int):
    """Column slice of pad_cols' image for label l (disparity gmin+l)."""
    return a_pad.narrow(1, left + gmin + l, W)


def window_mask(lo, hi, L):
    """(..., H, W) int windows -> (..., H, W, L) bool mask."""
    l_idx = torch.arange(L, dtype=torch.int32, device=lo.device)
    return (l_idx >= lo[..., None]) & (l_idx <= hi[..., None])


def chsum(d: torch.Tensor) -> torch.Tensor:
    """Sum over the last (channel) axis, left to right."""
    out = d[..., 0]
    for c in range(1, d.shape[-1]):
        out = out + d[..., c]
    return out


def fmin3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def sqrt_rn(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device.

    torch.sqrt of float32 on CUDA is not correctly rounded (about 0.6 %
    of values one ulp off on an H100); the float64 root rounded to
    float32 is (53 >= 2*24 + 2 bits, so the double rounding is exact),
    as is the CPU's and XLA's float32 sqrt."""
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)
