"""Dense cost-volume construction (counterpart of mgm_tpu/ops/cost.py).

Implements the builder semantics of mgm_costvolume.h:337-424 on dense
(H, W, L) float32 volumes over the global label axis:
  - label index l corresponds to disparity d = gmin + l
  - q outside the target image => cost = trunc_dist * nch
  - all costs truncated at trunc_dist * nch
  - +inf outside each pixel's [lo, hi] label window (Dvec semantics)
  - pixels whose whole window is non-finite are reset to 0
Cost functions (mgm_costvolume.h:19-165): ad, sd, census (on packed
codes), ncc (clipped, x64), btad, btsd.

NCC is tensor code here, as in the JAX module, finished by the tail
the other families share (cuda_cost.finish_volume).  The other
families go through K8 (ops/cuda_cost.cost_volume, the counterpart of
the TPU kernel pallas_cost.pointwise_volume and of the tail XLA fused
onto it), which writes the finished volume in one pass.  Channel sums
run left to right, divisions are true divisions by 0-dim tensors on
the operands' device and square roots are correctly rounded
(common.sqrt_rn), so CUDA and CPU agree bit for bit.
"""
from __future__ import annotations

import torch

from .common import (INF, chsum, fmin3, pad_cols, shift_fill, shifted_cols,
                     sqrt_rn, window_mask)
from .cuda_cost import (MODES, cost_volume, finish_volume,
                        pointwise_volume_plain)


def _bt_aux(a):
    """Per-channel 3-tap min/max of half-sample shifts (BTAD,
    mgm_costvolume.h:82-110)."""
    W = a.shape[1]
    x = torch.arange(W, device=a.device)[None, :, None]
    ap = torch.where(x < W - 1, (a + shift_fill(a, -1, 1, 0.0)) * 0.5, a)
    am = torch.where(x >= 1, (a + shift_fill(a, 1, 1, 0.0)) * 0.5, a)
    amin = fmin3(am, ap, a)
    amax = -fmin3(-am, -ap, -a)
    return amin, amax


def _box(a, hw):
    """Separable windowed sum over (2hw+1)^2 of the first two axes, zero
    outside the image."""
    out = a
    for axis in (0, 1):
        acc = out
        for s in range(1, hw + 1):
            acc = (acc + shift_fill(out, s, axis, 0.0)
                   + shift_fill(out, -s, axis, 0.0))
        out = acc
    return out


def pointwise_costs(u, v, gmin: int, L: int, distance: str, ncc_win: int):
    """Raw per-(pixel,label) matching costs, before truncation/masking.

    u, v: (H, W, C) preprocessed images (census: the packed words as
    int32).  Label l matches column x + gmin + l.  Returns (H, W, L)
    float32.  Every family but NCC is K8's plain raw costs
    (cuda_cost.pointwise_volume_plain), BT with its [I, Imin, Imax]
    channel blocks built here, as in the JAX module; they run on the
    CPU only (on a GPU K8 writes the finished volume,
    build_cost_volume)."""
    if distance == "ncc":
        return _ncc_costs(u, v, gmin, L, ncc_win)
    if distance not in MODES:
        raise ValueError(f"unknown distance {distance}")
    if u.device.type != "cpu":
        raise ValueError(f"pointwise_costs: the raw {distance} costs are "
                         f"the CPU's; on device {u.device} build_cost_volume "
                         f"runs K8")
    u, v = _bt_blocks(u, v, distance)
    return pointwise_volume_plain(u, v, gmin=gmin, L=L, mode=distance)


def _bt_blocks(u, v, distance):
    """BT's [I, Imin, Imax] channel blocks of both images; the images as
    they are for the other families."""
    if distance in ("btad", "btsd"):
        u = torch.cat([u, *_bt_aux(u)], -1)
        v = torch.cat([v, *_bt_aux(v)], -1)
    return u, v


def _ncc_costs(u, v, gmin, L, win, block: int = 8, rows=None, cols=None):
    """Clipped NCC x64 (mgm_costvolume.h:137-165); windows touching the
    image border are +inf (valnan semantics).  Labels go `block` at a
    time through the box filters, on (H, W, block, C) stacks.  rows,
    cols: the (start, stop) window of the image's volume to compute
    (default all of it), each element equal to the whole volume's: the
    box filters run on the window widened by the NCC window's apron
    (zero only beyond the image, as on the whole image; the apron's own
    sums, which would see zeros at the cut, are cut away)."""
    H, W, C = u.shape
    y0, y1 = rows or (0, H)
    x0, x1 = cols or (0, W)
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    hw = win // 2
    if H <= 2 * hw:
        return torch.full((y1 - y0, x1 - x0, L), INF, **f32)
    ya, yb = max(0, y0 - hw), min(H, y1 + hw)
    xa, xb = max(0, x0 - hw), min(W, x1 + hw)
    u, v = u[ya:yb, xa:xb], v[ya:yb]
    n = torch.tensor(float((2 * hw + 1) ** 2), **f32)
    x = torch.arange(xa, xb, device=dev)
    ys = torch.arange(ya, yb, device=dev)
    y_ok = (ys >= hw) & (ys < H - hw)
    mu1 = _box(u, hw) / n
    s1 = _box(u * u, hw) / n
    mu2 = _box(v, hw) / n
    s2 = _box(v * v, hw) / n
    var1 = s1 - mu1 * mu1
    # label l of column x reads column x + gmin + l, clamped to the
    # image (pad_cols' edge padding)
    vms_pad, left = pad_cols(torch.cat([v, mu2, s2], -1), gmin, L)
    eps = torch.tensor(1e-7, **f32)
    x_ok = ((x >= hw) & (x < W - hw))[None, :, None]
    blocks = []
    for l0 in range(0, L, block):
        nb = min(block, L - l0)
        # (h, w, nb, 3C): label l0+k reads columns shifted by k
        sb = torch.stack([shifted_cols(vms_pad, left + xa, gmin, l0 + k,
                                       xb - xa) for k in range(nb)], 2)
        vg, mu2g, s2g = sb[..., :C], sb[..., C:2 * C], sb[..., 2 * C:]
        prod = _box(u[:, :, None, :] * vg, hw) / n
        denom = sqrt_rn(torch.maximum(
            eps, var1[:, :, None, :] * (s2g - mu2g * mu2g)))
        ncc = chsum((prod - mu1[:, :, None, :] * mu2g) / denom)
        clipped = (float(C) - ncc.clamp(0.0, float(C))) * 64.0
        qx = x[None, :, None] + (gmin + l0
                                 + torch.arange(nb, device=dev)[None, None])
        ok = x_ok & (qx >= hw) & (qx < W - hw) & y_ok[:, None, None]
        blocks.append(torch.where(ok, clipped, INF))
    return torch.cat(blocks, -1)[y0 - ya:y1 - ya, x0 - xa:x1 - xa]


def build_cost_volume(u, v, lo, hi, gmin: int, *, distance: str, L: int,
                      trunc_dist: float, ncc_win: int = 3, out=None,
                      rows: slice | None = None, cols: slice | None = None):
    """Dense (H, W, L) float32 cost volume.

    u, v: preprocessed images (H, W, C); lo/hi: (H, W) int32 label
    windows; gmin: int, disparity of label 0; out: an (H, W, L) float32
    tensor to write it into (a slice of a stack of volumes), or None.
    rows, cols: a window of the image (slices with unit step, default
    all of it): the (rows, cols, L) part of the volume, each element
    equal to the whole volume's (a mesh rank's band).
    The pointwise families are one K8 call (cuda_cost.cost_volume)
    a row band (a band of columns: one a band of rows of the whole
    width, cut); NCC is tensor code finished by cuda_cost.finish_volume."""
    H, W = u.shape[:2]
    y0, y1, _ = (rows or slice(0, H)).indices(H)
    x0, x1, _ = (cols or slice(0, W)).indices(W)
    tmax = trunc_dist * u.shape[-1]
    if y0 == y1 or x0 == x1:   # an empty band: no kernel to launch
        vol = torch.empty((y1 - y0, x1 - x0, L), dtype=torch.float32,
                          device=u.device)
        return vol if out is None else out
    if distance == "ncc":
        vol = finish_volume(
            _ncc_costs(u, v, gmin, L, ncc_win, rows=(y0, y1),
                       cols=(x0, x1)), lo[y0:y1, x0:x1], hi[y0:y1, x0:x1],
            gmin, tmax, x0=x0, width=W)
        return vol if out is None else out.copy_(vol)
    if distance not in MODES:
        raise ValueError(f"unknown distance {distance}")
    u, v = _bt_blocks(u, v, distance)
    kw = dict(gmin=gmin, L=L, mode=distance, tmax=tmax)
    if (x0, x1) == (0, W):
        return cost_volume(u[y0:y1], v[y0:y1], lo[y0:y1], hi[y0:y1],
                           out=out, **kw)
    # the pointwise costs of a row depend on that row only: rows of the
    # whole width, as many as the band's pixels, then their columns
    if out is None:
        out = torch.empty((y1 - y0, x1 - x0, L), dtype=torch.float32,
                          device=u.device)
    step = max(1, -(-(y1 - y0) * (x1 - x0) // W))
    for a in range(y0, y1, step):
        b = min(a + step, y1)
        out[a - y0:b - y0] = cost_volume(u[a:b], v[a:b], lo[a:b], hi[a:b],
                                         **kw)[:, x0:x1]
    return out
