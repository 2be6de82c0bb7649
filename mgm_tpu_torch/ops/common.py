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
