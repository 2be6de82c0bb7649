"""A rectified stereo pair with a known disparity field, made from a seed.

The pair stands in for real data where none is at hand (smoke runs,
tests): a smoothed random RGB texture seen by the right camera, and a
left view warped from it by a piecewise-constant disparity field
(horizontal bands, each with one rectangular object at its own
disparity), both with Gaussian noise.  Left pixel (r, c) shows the
texture point that the right image has at column c + d(r, c), which is
MGM's convention (cost of label d compares u(c) with v(c + d)).
"""
from __future__ import annotations

import numpy as np


def _smooth(a: np.ndarray, axis: int) -> np.ndarray:
    """[1, 2, 1] / 4 along `axis`, edges replicated."""
    p = [(0, 0)] * a.ndim
    p[axis] = (1, 1)
    b = np.pad(a, p, mode="edge")
    n = a.shape[axis]
    s = [np.take(b, np.arange(k, k + n), axis=axis) for k in range(3)]
    return (s[0] + 2 * s[1] + s[2]) / 4


def _planted(rng, H: int, W: int, lo: int, hi: int, bands: int):
    """(H, W) int32 piecewise-constant field drawn from lo..hi:
    horizontal bands, each with one rectangular object at its own
    value."""
    d = np.empty((H, W), np.int32)
    edges = np.linspace(0, H, bands + 1).astype(int)
    for r0, r1 in zip(edges[:-1], edges[1:]):
        d[r0:r1] = rng.integers(lo, hi + 1)
        # one object per band, a third of the band's height and of W
        h = max(1, (r1 - r0) // 3)
        c0 = int(rng.integers(0, max(1, W - W // 3)))
        ro = r0 + (r1 - r0 - h) // 2
        d[ro:ro + h, c0:c0 + W // 3] = rng.integers(lo, hi + 1)
    return d


def synthetic_mrf(H: int, W: int, L: int, *, seed: int = 0, bands: int = 5,
                  noise: float = 6.0):
    """A grid-MRF problem with a planted labelling, made from a seed.

    Returns (unary, weights, labels): the (H, W, L) float32 unary
    cost 4 min(|l - labels|, 16) + |Gaussian noise| drawn independently
    per (pixel, label), so each pixel's own minimum often misses; the
    (H, W, 8) float32 edge weights drawn from {0.25, 1}; and the int32
    (H, W) planted labelling in 0..L-1."""
    rng = np.random.default_rng(seed)
    labels = _planted(rng, H, W, 0, L - 1, bands)
    dist = np.abs(np.arange(L)[None, None, :] - labels[..., None])
    unary = (4.0 * np.minimum(dist, 16)
             + np.abs(rng.normal(0.0, noise, (H, W, L)))).astype(np.float32)
    weights = np.where(rng.random((H, W, 8)) < 0.5, 0.25,
                       1.0).astype(np.float32)
    return unary, weights, labels


def synthetic_pair(H: int, W: int, dmin: int, dmax: int, *, seed: int = 0,
                   bands: int = 5, noise: float = 2.0):
    """Returns (u, v, d_true): uint8 (H, W, 3) left and right images and
    the int32 (H, W) true disparity, drawn from dmin..dmax."""
    rng = np.random.default_rng(seed)
    d = _planted(rng, H, W, dmin, dmax, bands)
    # the texture spans every column either view can see
    off = -min(dmin, 0)
    Wt = off + W + max(dmax, 0)
    tex = rng.random((H, Wt, 3))
    for _ in range(2):
        tex = _smooth(_smooth(tex, 0), 1)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 235 + 10
    v = tex[:, off:off + W]
    cols = np.arange(W)[None, :] + d + off
    u = np.take_along_axis(tex, cols[..., None].repeat(3, -1), axis=1)

    def quantise(a):
        a = a + rng.normal(0.0, noise, a.shape)
        return np.clip(np.round(a), 0, 255).astype(np.uint8)

    return quantise(u), quantise(v), d
