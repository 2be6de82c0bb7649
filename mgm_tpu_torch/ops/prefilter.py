"""Prefilters: sobelx, truncated gaussian blur (counterpart of
mgm_tpu/ops/prefilter.py; census lives in census.py).

Semantics mirror the reference registry (mgm_costvolume.h:194-207,
368-384) and filters (img_tools.h:105-180): correlation with
clamp-to-edge boundary, truncated normalised gaussian of width
clamp(ceil(1+6|sigma|), 1, 39).  The registry's `sobel_x` -> none
quirk lives in config.resolve_prefilter.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import shift_edge

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def correlate2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlation of (H, W, C) with a small (kh, kw) kernel,
    clamp-to-edge boundary, accumulating taps in (row, col) scan order
    to match the reference's float summation (img_tools.h:111-124).
    Each tap is a float32 product (the kernel's values are float32)."""
    kh, kw = kernel.shape
    hy, hx = kh // 2, kw // 2
    out = None
    for j in range(kh):
        for i in range(kw):
            kv = float(kernel[j, i])
            if kv == 0.0:
                continue
            term = shift_edge(shift_edge(img, hy - j, 0), hx - i, 1) * kv
            out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(img)


def sobelx(img: torch.Tensor) -> torch.Tensor:
    return correlate2d(img, SOBEL_X)


def gblur_kernel(sigma: float) -> np.ndarray:
    width = int(np.ceil(1 + 2 * (3 * abs(sigma))))
    width = min(max(width, 1), 39)
    c = (width - 1) // 2
    k = np.exp(-((np.arange(width, dtype=np.float32) - c) ** 2)
               / np.float32(2 * sigma * sigma)).astype(np.float32)
    return (k / k.sum()).astype(np.float32)


def gblur(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    k = gblur_kernel(sigma)
    tmp = correlate2d(img, k[None, :])
    return correlate2d(tmp, k[:, None])


def apply_prefilter(img: torch.Tensor, name: str) -> torch.Tensor:
    if name == "sobelx":
        return sobelx(img)
    if name == "gblur":
        return gblur(img, 1.0)
    return img
