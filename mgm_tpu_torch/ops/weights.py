"""Adaptive P1/P2 edge weights (mgm_weights.h:26-85; mirror of
mgm_tpu/ops/weights.py).

8 channels in neighbour order W, E, S, N, NW, NE, SE, SW; weight = aP
where the mean squared channel intensity difference to that neighbour is
< thresh^2, else 1; out-of-image neighbours get 1.
"""
from __future__ import annotations

import torch

from .common import shift_fill

# (dx, dy) per channel, mgm_weights.h:69
SCANS = ((-1, 0), (1, 0), (0, 1), (0, -1), (-1, -1), (1, -1), (1, 1), (-1, 1))


def compute_weights(img: torch.Tensor, a_p: float,
                    thresh: float) -> torch.Tensor:
    """img: (H, W, C) float32 -> (H, W, 8) float32.

    All arithmetic is float32 in the reference's order: the channel sum
    runs left to right and the division is a true division (a 0-dim
    tensor on the image's device, so CUDA does not swap it for a
    reciprocal multiply)."""
    f32 = dict(dtype=torch.float32, device=img.device)
    C = img.shape[-1]
    thr = torch.tensor(thresh, **f32)
    thr2 = thr * thr
    nch = torch.tensor(float(C), **f32)
    w_in = torch.tensor(a_p, **f32)
    one = torch.tensor(1.0, **f32)
    planes = []
    for dx, dy in SCANS:
        nb = shift_fill(shift_fill(img, -dy, 0, float("nan")), -dx, 1,
                        float("nan"))
        diff = img - nb
        sq = diff * diff
        acc = sq[..., 0]
        for c in range(1, C):
            acc = acc + sq[..., c]
        delta = acc / nch
        w = torch.where(delta.abs() < thr2, w_in, one)
        planes.append(torch.where(torch.isnan(delta), one, w))
    return torch.stack(planes, -1)
