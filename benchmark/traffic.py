"""The traffic of a cell: its pool of seeded image pairs and the order in
which one closed-loop client sends them.

A traffic file (traffic/<name>.json) gives the entry that serves a
request, the pairs a request carries, the size of the pool, the warm-up
and how many requests the output check samples.  A configuration file
gives the geometry and, under "data", the generator's parameters.

The pairs follow the recipe of a seeded synthetic rectified pair (a
smoothed random RGB texture seen by the right camera; the left view
warped from it by a piecewise-constant disparity field of horizontal
bands, each with one rectangular object at its own disparity; Gaussian
noise on both; MGM's convention: left pixel x shows the right image's
column x + d), made for the whole pool at once on the device and then
kept on the host, since a request hands the program host arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _smooth(a, axis: int):
    """[1, 2, 1] / 4 along `axis`, edges replicated."""
    n = a.shape[axis]
    idx = torch.arange(n, device=a.device)
    lo = a.index_select(axis, (idx - 1).clamp(0, n - 1))
    hi = a.index_select(axis, (idx + 1).clamp(0, n - 1))
    return (lo + 2 * a + hi) / 4


def _planted(rng, P: int, H: int, W: int, lo: int, hi: int, bands: int):
    """(P, H, W) int64 disparity fields drawn from lo..hi."""
    d = np.empty((P, H, W), np.int64)
    edges = np.linspace(0, H, bands + 1).astype(int)
    for k in range(P):
        for r0, r1 in zip(edges[:-1], edges[1:]):
            d[k, r0:r1] = rng.integers(lo, hi + 1)
            h = max(1, (r1 - r0) // 3)
            c0 = int(rng.integers(0, max(1, W - W // 3)))
            ro = r0 + (r1 - r0 - h) // 2
            d[k, ro:ro + h, c0:c0 + W // 3] = rng.integers(lo, hi + 1)
    return d


def make_pool(config: dict, traffic: dict, seed: int, device) -> tuple:
    """(us, vs): the uint8 (P, H, W, C) left and right images of the
    cell's pool, on the host, the same for the same seed on the same
    kind of device."""
    H, W, C = config["height"], config["width"], config["channels"]
    dmin, dmax = config["settings"]["dmin"], config["settings"]["dmax"]
    data = config["data"]
    P = traffic["pool_pairs"]
    rng = np.random.default_rng([seed, 0])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed, 1]).integers(2**62)))
    d = _planted(rng, P, H, W, dmin, dmax, data["bands"])
    off = -min(dmin, 0)
    Wt = off + W + max(dmax, 0)
    tex = torch.rand((P, H, Wt, C), generator=gen, device=device,
                     dtype=torch.float64)
    for _ in range(2):
        tex = _smooth(_smooth(tex, 1), 2)
    lo = tex.amin((1, 2, 3), keepdim=True)
    hi = tex.amax((1, 2, 3), keepdim=True)
    tex = (tex - lo) / (hi - lo) * 235 + 10
    v = tex[:, :, off:off + W]
    cols = torch.as_tensor(np.arange(W)[None, None, :] + d + off,
                           device=device)
    u = tex.gather(2, cols[..., None].expand(-1, -1, -1, C))

    def quantise(a):
        a = a + torch.randn(a.shape, generator=gen, device=device,
                            dtype=a.dtype) * data["noise"]
        return a.round().clamp(0, 255).to(torch.uint8).cpu().numpy()

    return quantise(u), quantise(v)


def request_groups(traffic: dict, seed: int):
    """An endless iterator of the pool indices each request carries:
    the pool cut into groups of `pairs_per_request` consecutive pairs,
    sent in a seeded order, every group once a cycle."""
    k = traffic["pairs_per_request"]
    groups = [tuple(range(g, g + k))
              for g in range(0, traffic["pool_pairs"], k)]
    rng = np.random.default_rng([seed, 2])
    while True:
        for g in rng.permutation(len(groups)):
            yield groups[g]
