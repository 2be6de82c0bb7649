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

NCC is tensor code here, as in the JAX module.  The other families are
the plain version of the TPU kernel pallas_cost.pointwise_volume (K8),
which has no CUDA counterpart yet: on a CUDA device they raise
NotImplementedError rather than run the plain version there.  Channel
sums run left to right, divisions are true divisions by 0-dim tensors
on the operands' device and square roots are correctly rounded
(common.sqrt_rn), so CUDA and CPU agree bit for bit.
"""
from __future__ import annotations

import torch

from .common import INF, fmin3, shift_fill, sqrt_rn

# where the CUDA counterpart of K8 is planned
K8_ROADMAP = ("pointwise ad/sd/census/btad/btsd volumes on a GPU need "
              "K8 (pallas_cost.pointwise_volume): ROADMAP queue 1, the "
              "ndir-16 leftover slice (item 5)")


def window_mask(lo, hi, L):
    """(..., H, W) int windows -> (..., H, W, L) bool mask."""
    l_idx = torch.arange(L, dtype=torch.int32, device=lo.device)
    return (l_idx >= lo[..., None]) & (l_idx <= hi[..., None])


def _pad_cols(a, gmin: int, L: int):
    """Edge-pad the columns of (H, W, C) so every disparity
    d = gmin..gmin+L-1 becomes the slice a_pad[:, x + d - gmin + left].
    Out-of-image labels are masked to trunc_dist by the builder."""
    W = a.shape[1]
    left = max(0, -gmin)
    right = max(0, gmin + L - 1)
    idx = torch.arange(-left, W + right, device=a.device).clamp(0, W - 1)
    return a.index_select(1, idx), left


def _shifted(a_pad, left: int, gmin: int, l: int, W: int):
    """Column slice of the padded image for label l (disparity gmin+l)."""
    return a_pad.narrow(1, left + gmin + l, W)


def _chsum(d):
    """Sum over the last (channel) axis, left to right."""
    out = d[..., 0]
    for c in range(1, d.shape[-1]):
        out = out + d[..., c]
    return out


def _per_label(u, v, gmin: int, L: int, fn):
    """Stack fn(u, v_shifted_by_label) over labels -> (H, W, L)."""
    W = v.shape[1]
    v_pad, left = _pad_cols(v, gmin, L)
    cols = [fn(u, _shifted(v_pad, left, gmin, l, W)) for l in range(L)]
    return torch.stack(cols, -1)


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


def _popcount32(x):
    """Set bits of each int64 entry holding a value in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def pointwise_costs(u, v, gmin: int, L: int, distance: str, ncc_win: int):
    """Raw per-(pixel,label) matching costs, before truncation/masking.

    u, v: (H, W, C) preprocessed images (uint32 census codes, or int64
    holding them, for 'census').  Label l matches column x + gmin + l.
    Returns (H, W, L) float32."""
    if distance == "ncc":
        return _ncc_costs(u, v, gmin, L, ncc_win)
    if u.device.type != "cpu":
        raise NotImplementedError(K8_ROADMAP)
    if distance == "census":
        inv_nw = torch.tensor(1.0 / u.shape[2], dtype=torch.float32)
        cu, cv = u.to(torch.int64), v.to(torch.int64)

        def ham(a, b_sh):
            x = _popcount32(a ^ b_sh).sum(-1)
            return x.to(torch.float32) * inv_nw

        return _per_label(cu, cv, gmin, L, ham)

    if distance in ("ad", "sd"):
        def diff(a, b_sh):
            d = (a - b_sh).abs()
            if distance == "sd":
                d = d * d
            return _chsum(d)

        return _per_label(u, v, gmin, L, diff)

    if distance in ("btad", "btsd"):
        umin, umax = _bt_aux(u)
        vmin, vmax = _bt_aux(v)
        W, C = v.shape[1], v.shape[2]
        v3_pad, left = _pad_cols(torch.cat([v, vmin, vmax], -1), gmin, L)
        zero = torch.zeros((), dtype=torch.float32)

        def bt_cost(l):
            sh = _shifted(v3_pad, left, gmin, l, W)
            IR, vmin_g, vmax_g = sh[..., :C], sh[..., C:2 * C], sh[..., 2 * C:]
            dLR = -fmin3(zero, -(u - vmax_g), -(vmin_g - u))
            dRL = -fmin3(zero, -(IR - umax), -(umin - IR))
            bt = torch.minimum(dLR, dRL).abs()
            if distance == "btsd":
                bt = bt * bt
            return _chsum(bt)

        return torch.stack([bt_cost(l) for l in range(L)], -1)

    raise ValueError(f"unknown distance {distance}")


def _ncc_costs(u, v, gmin, L, win, block: int = 8):
    """Clipped NCC x64 (mgm_costvolume.h:137-165); windows touching the
    image border are +inf (valnan semantics).  Labels go `block` at a
    time through the box filters, on (H, W, block, C) stacks."""
    H, W, C = u.shape
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    hw = win // 2
    if H <= 2 * hw:
        return torch.full((H, W, L), INF, **f32)
    n = torch.tensor(float((2 * hw + 1) ** 2), **f32)
    x = torch.arange(W, device=dev)
    rows = torch.arange(H, device=dev)
    y_ok = (rows >= hw) & (rows < H - hw)
    mu1 = _box(u, hw) / n
    s1 = _box(u * u, hw) / n
    mu2 = _box(v, hw) / n
    s2 = _box(v * v, hw) / n
    var1 = s1 - mu1 * mu1
    vms_pad, left = _pad_cols(torch.cat([v, mu2, s2], -1), gmin, L)
    eps = torch.tensor(1e-7, **f32)
    x_ok = ((x >= hw) & (x < W - hw))[None, :, None]
    blocks = []
    for l0 in range(0, L, block):
        nb = min(block, L - l0)
        # (H, W, nb, 3C): label l0+k reads columns shifted by k
        sb = torch.stack([_shifted(vms_pad, left, gmin, l0 + k, W)
                          for k in range(nb)], 2)
        vg, mu2g, s2g = sb[..., :C], sb[..., C:2 * C], sb[..., 2 * C:]
        prod = _box(u[:, :, None, :] * vg, hw) / n
        denom = sqrt_rn(torch.maximum(
            eps, var1[:, :, None, :] * (s2g - mu2g * mu2g)))
        ncc = _chsum((prod - mu1[:, :, None, :] * mu2g) / denom)
        clipped = (float(C) - ncc.clamp(0.0, float(C))) * 64.0
        qx = x[None, :, None] + (gmin + l0
                                 + torch.arange(nb, device=dev)[None, None])
        ok = x_ok & (qx >= hw) & (qx < W - hw) & y_ok[:, None, None]
        blocks.append(torch.where(ok, clipped, INF))
    return torch.cat(blocks, -1)


def build_cost_volume(u, v, lo, hi, gmin: int, *, distance: str, L: int,
                      trunc_dist: float, ncc_win: int = 3):
    """Dense (H, W, L) float32 cost volume.

    u, v: preprocessed images (H, W, C); lo/hi: (H, W) int32 label
    windows; gmin: int, disparity of label 0."""
    H, W, C = u.shape
    dev = u.device
    tmax = torch.tensor(trunc_dist * C, dtype=torch.float32, device=dev)
    d = gmin + torch.arange(L, dtype=torch.int32, device=dev)
    qx = torch.arange(W, dtype=torch.int32, device=dev)[:, None] + d[None, :]
    valid_q = (qx >= 0) & (qx < W)

    e = pointwise_costs(u, v, gmin, L, distance, ncc_win)
    e = torch.where(valid_q[None], e, tmax)
    e = torch.minimum(e, tmax)

    in_win = window_mask(lo, hi, L)
    allinvalid = ~(in_win & torch.isfinite(e)).any(-1, keepdim=True)
    e = torch.where(allinvalid, 0.0, e)
    return torch.where(in_win, e, INF).to(torch.float32)
