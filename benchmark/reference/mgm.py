"""Plain PyTorch reference of MGM stereo matching (gfacciol/mgm's `mgm`).

One pair's pipeline, as the reference binary defines it (mgm.cc:266-450,
mgm_core.cc:408-613, mgm_costvolume.h:137-165 and :337-424):

  images scrubbed (NaN/inf -> 0), P1 and P2 scaled by the channel count;
  cost volume of each LR side over its label range (side 1 swaps the
  images and negates the range): AD summed over the channels, or NCC
  clipped and scaled by 64 on (2h+1)^2 windows (+inf where a window
  leaves the image); +inf for labels whose match lies off the image;
  a pixel with no finite label in its window takes 0 for all of them;
  every scan pass p of the first `ndir` (image-space causal neighbours
  PASS_DIRS[p]) aggregates Lr(x) = C(x) + e, e the TSGM mean of the
  SGM messages min(Lk[l], Lk[l+-1] + P1, min Lk + P2) - min Lk of its
  first `mgm` neighbours, except on the image sides its four
  neighbours point to, where Lr = C;
  S = sum of the passes in pass order - (ndir - 1) C; the disparity is
  the first label of least finite S, its cost that S;
  vfit refinement on S; the LR check both ways with tolerance tau.

Written for the settings the benchmark's configurations state (AD or
NCC, no prefilter, no edge weights, the SGM potential, one iteration,
no median); others raise.  Fronts are vectorised: each pass scans the
lines a*x + b*y = t of a schedule under which its neighbours come
earlier, and passes with as many fronts run in one sweep.

`dtype` sets the precision of the images, volumes, recursion and S
(the refinement and the LR check stay float32): float32 is the
reference, bfloat16 the control that a lower-precision solve must
fail.  Imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INF = float("inf")

# image-space causal neighbours (dx, dy), dir1..dir4, of each pass
# (mgm_core.cc:463-471)
PASS_DIRS = (
    ((-1, 0), (0, -1), (-1, -1), (1, -1)),
    ((1, 0), (0, 1), (1, 1), (-1, 1)),
    ((0, 1), (-1, 0), (-1, 1), (-1, -1)),
    ((0, -1), (1, 0), (1, -1), (1, 1)),
    ((-1, -1), (1, -1), (0, -1), (1, 0)),
    ((1, -1), (1, 1), (1, 0), (0, 1)),
    ((1, 1), (-1, 1), (0, 1), (-1, 0)),
    ((-1, 1), (-1, -1), (-1, 0), (0, -1)),
)

DEFAULTS = dict(dmin=-30, dmax=30, ndir=4, p1=8.0, p2=32.0, mgm=4,
                distance="ad", prefilter="none", refinement="none",
                trunc_dist=INF, a_p2=1.0, census_ncc_win=3,
                use_trunc_linear=False, fix_overcount=True, iterations=1,
                median_radius=0, test_lr=True, lr_tau=1.0)


def settings_of(settings: dict) -> dict:
    """The settings over DEFAULTS (the binary's defaults), refusing
    what this reference does not implement."""
    s = dict(DEFAULTS)
    s.update(settings)
    s["trunc_dist"] = float(s["trunc_dist"])
    unsupported = {
        "distance": s["distance"] not in ("ad", "ncc"),
        "prefilter": s["prefilter"] != "none",
        "refinement": s["refinement"] not in ("none", "vfit"),
        "a_p2": s["a_p2"] != 1.0,
        "use_trunc_linear": bool(s["use_trunc_linear"]),
        "iterations": s["iterations"] != 1,
        "median_radius": s["median_radius"] != 0,
        "ndir": not 1 <= s["ndir"] <= 8,
        "mgm": s["mgm"] not in (1, 2, 3, 4),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"reference.mgm: unsupported settings {bad}")
    return s


# ------------------------------------------------------------- costs ----

def _shift(a, off: int, axis: int):
    """b[i] = a[i - off] along `axis`, 0 where that leaves the array."""
    if off == 0:
        return a
    n = a.shape[axis]
    pad = [0, 0] * (a.ndim - axis - 1)
    if off > 0:
        return F.pad(a, pad + [off, 0]).narrow(axis, 0, n)
    return F.pad(a, pad + [0, -off]).narrow(axis, -off, n)


def _box(a, hw: int):
    """Sum over the (2hw+1)^2 window of axes 0 and 1, zero outside."""
    out = a
    for axis in (0, 1):
        acc = out
        for s in range(1, hw + 1):
            acc = acc + _shift(out, s, axis) + _shift(out, -s, axis)
        out = acc
    return out


def _chsum(d):
    """Sum over the last axis, left to right."""
    out = d[..., 0]
    for c in range(1, d.shape[-1]):
        out = out + d[..., c]
    return out


def _match_cols(W: int, gmin: int, labels, device):
    """(W, n) columns x + gmin + l of the labels, and whether each lies
    on the image."""
    x = torch.arange(W, device=device)[:, None]
    q = x + gmin + torch.as_tensor(labels, device=device)[None, :]
    return q.clamp(0, W - 1), (q >= 0) & (q < W)


def ad_costs(a, b, gmin: int, L: int):
    """(H, W, L) sum over channels of |a(x) - b(x + gmin + l)|; +inf
    where the match lies off the image."""
    qc, on = _match_cols(a.shape[1], gmin, range(L), a.device)
    e = _chsum((a[:, :, None, :] - b[:, qc]).abs())
    return torch.where(on[None], e, INF)


def ncc_costs(a, b, gmin: int, L: int, win: int, block: int = 32):
    """(H, W, L) clipped NCC x 64 (mgm_costvolume.h:137-165): per
    channel the normalised cross-correlation of the windows at x and
    x + gmin + l, summed over the channels, clipped to [0, C], and
    (C - ncc) * 64; +inf where either window leaves the image."""
    H, W, C = a.shape
    dev, dt = a.device, a.dtype
    hw = win // 2
    n = torch.tensor(float((2 * hw + 1) ** 2), dtype=dt, device=dev)
    eps = torch.tensor(1e-7, dtype=dt, device=dev)
    mu1, s1 = _box(a, hw) / n, _box(a * a, hw) / n
    mu2, s2 = _box(b, hw) / n, _box(b * b, hw) / n
    var1 = s1 - mu1 * mu1
    y = torch.arange(H, device=dev)
    x = torch.arange(W, device=dev)
    inside = (((y >= hw) & (y < H - hw))[:, None, None]
              & ((x >= hw) & (x < W - hw))[None, :, None])
    out = []
    for l0 in range(0, L, block):
        labels = range(l0, min(L, l0 + block))
        qc, _ = _match_cols(W, gmin, labels, dev)
        q = x[:, None] + gmin + torch.as_tensor(labels, device=dev)[None]
        bq, mu2q, s2q = b[:, qc], mu2[:, qc], s2[:, qc]
        prod = _box(a[:, :, None, :] * bq, hw) / n
        var2 = s2q - mu2q * mu2q
        denom = torch.sqrt(torch.maximum(eps, var1[:, :, None] * var2)
                           .to(torch.float64)).to(dt)
        ncc = _chsum((prod - mu1[:, :, None] * mu2q) / denom)
        cost = (float(C) - ncc.clamp(0.0, float(C))) * 64.0
        ok = inside & ((q >= hw) & (q < W - hw))[None]
        out.append(torch.where(ok, cost, INF))
    return torch.cat(out, -1)


def cost_volume(a, b, gmin: int, lo: int, hi: int, s: dict, L: int):
    """The finished (H, W, L) volume of one side: the costs truncated at
    trunc_dist * C (the truncation also for off-image matches), 0 for
    every label of a pixel with no finite cost in [lo, hi], +inf
    outside [lo, hi]."""
    C = a.shape[-1]
    if s["distance"] == "ncc":
        e = ncc_costs(a, b, gmin, L, s["census_ncc_win"])
    else:
        e = ad_costs(a, b, gmin, L)
    _, on = _match_cols(a.shape[1], gmin, range(L), a.device)
    tmax = torch.tensor(s["trunc_dist"] * C, dtype=e.dtype, device=e.device)
    e = torch.minimum(torch.where(on[None], e, tmax), tmax)
    lab = torch.arange(L, device=e.device)
    in_win = (lab >= lo) & (lab <= hi)
    none = ~(in_win & torch.isfinite(e)).any(-1, keepdim=True)
    e = torch.where(none, 0.0, e)
    return torch.where(in_win, e, INF)


# -------------------------------------------------------- recursion ----

def _schedule(dirs, H: int, W: int):
    """(T, a, b): the fewest fronts T of a schedule t = a*x + b*y under
    which every neighbour (dx, dy) in `dirs` lies on an earlier front."""
    best = None
    for a in range(-2, 3):
        for b in range(-2, 3):
            if all(a * dx + b * dy < 0 for dx, dy in dirs):
                T = abs(a) * (W - 1) + abs(b) * (H - 1) + 1
                if best is None or T < best[0]:
                    best = (T, a, b)
    return best


def _sweep_plan(passes, mgm: int, H: int, W: int, device):
    """Index tables of one sweep over `passes`, which have as many
    fronts: every element, front by front, names its pass's slot
    p * H*W + pixel, its pixel, whether it aggregates, and the slots of
    its `mgm` neighbours."""
    HW = H * W
    y, x = np.divmod(np.arange(HW), W)
    keys, slot, pix, inner, nbs = [], [], [], [], []
    for k, p in enumerate(passes):
        dirs = PASS_DIRS[p]
        _, a, b = _schedule(dirs[:mgm], H, W)
        t = a * x + b * y
        keys.append((t - t.min()) * len(passes) + k)
        slot.append(k * HW + np.arange(HW))
        pix.append(np.arange(HW))
        # the binary skips the image sides any of the pass's four
        # neighbours points to (mgm_core.cc:538-541)
        ok = np.ones(HW, bool)
        if any(dx < 0 for dx, _ in dirs):
            ok &= x >= 1
        if any(dx > 0 for dx, _ in dirs):
            ok &= x <= W - 2
        if any(dy < 0 for _, dy in dirs):
            ok &= y >= 1
        if any(dy > 0 for _, dy in dirs):
            ok &= y <= H - 2
        inner.append(ok)
        nbs.append([k * HW + np.clip(y + dy, 0, H - 1) * W
                    + np.clip(x + dx, 0, W - 1) for dx, dy in dirs[:mgm]])
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    front = key[order] // len(passes)
    bounds = np.searchsorted(front, np.arange(front.max() + 2))
    to = lambda a: torch.as_tensor(a[order], device=device)  # noqa: E731
    return dict(slot=to(np.concatenate(slot)), pix=to(np.concatenate(pix)),
                inner=to(np.concatenate(inner)),
                nbs=[to(np.concatenate([n[j] for n in nbs]))
                     for j in range(mgm)],
                bounds=bounds.tolist())


def _message(f, mk, p1, p2):
    """min(Lk[l], min(Lk[l-1], Lk[l+1]) + P1, min Lk + P2) - min Lk."""
    up = F.pad(f[..., 1:], (0, 1), value=INF)
    down = F.pad(f[..., :-1], (1, 0), value=INF)
    m = torch.minimum(torch.minimum(f, torch.minimum(up, down) + p1),
                      mk + p2)
    return m - mk


def _sweep(cc, H: int, W: int, passes, mgm: int, p1, p2):
    """Lr of each pass in `passes` over the (n, H*W, L) volume cc:
    (n, len(passes) * H*W, L)."""
    n, HW, L = cc.shape
    plan = _sweep_plan(passes, mgm, H, W, cc.device)
    out = torch.empty((n, len(passes) * HW, L), dtype=cc.dtype,
                      device=cc.device)
    mins = torch.empty((n, len(passes) * HW), dtype=cc.dtype,
                       device=cc.device)
    half = torch.tensor(0.5, dtype=cc.dtype, device=cc.device)
    div = torch.tensor(float(mgm), dtype=cc.dtype, device=cc.device)
    b = plan["bounds"]
    for s, e in zip(b[:-1], b[1:]):
        if s == e:
            continue
        slot = plan["slot"][s:e]
        cur = cc[:, plan["pix"][s:e]]
        msgs = []
        for nb in plan["nbs"]:
            i = nb[s:e]
            msgs.append(_message(out[:, i], mins[:, i, None], p1, p2))
        if mgm == 2:
            # update_cost2 halves each term before the sum
            # (mgm_core.cc:83-84)
            agg = msgs[0] * half + msgs[1] * half
        else:
            agg = msgs[0]
            for m in msgs[1:]:
                agg = agg + m
            if mgm > 1:
                agg = agg / div
        new = torch.where(plan["inner"][s:e][None, :, None], cur + agg, cur)
        out[:, slot] = new
        mins[:, slot] = new.amin(-1)
    return out


def aggregate(cc, ndir: int, mgm: int, p1, p2):
    """Sum in pass order 0 .. ndir-1 of every pass's Lr over the
    (n, H, W, L) volume cc."""
    n, H, W, L = cc.shape
    flat = cc.reshape(n, H * W, L)
    by_T = {}
    for p in range(ndir):
        T = _schedule(PASS_DIRS[p][:mgm], H, W)[0]
        by_T.setdefault(T, []).append(p)
    total, ready, nxt = None, {}, 0
    for passes in sorted(by_T.values(), key=min):
        out = _sweep(flat, H, W, passes, mgm, p1, p2)
        for k, p in enumerate(passes):
            ready[p] = out[:, k * H * W:(k + 1) * H * W]
        del out
        while nxt in ready:
            lr = ready.pop(nxt)
            total = lr.clone() if total is None else total + lr
            nxt += 1
    return total.reshape(n, H, W, L)


# ------------------------------------------------------ WTA, refine ----

def _vfit(v0, v1, v2):
    """refine.h's V fit: (value at the minimum, offset of the
    minimum)."""
    guard = (v1 > v0) & (v1 > v2)
    slope = torch.where((v2 - v1) < (v0 - v1), v0 - v1, v2 - v1)
    x = (v0 - v2) / (2.0 * slope)
    vm = v2 + (x - 1.0) * slope
    return torch.where(guard, v1, vm), torch.where(guard, 0.0, x)


def solve(cc, lo: int, hi: int, gmin: int, s: dict, p1, p2):
    """(disp, cost) float32 (n, H, W) of the volumes cc (n, H, W, L):
    the WTA on S, refined as the settings say."""
    L = cc.shape[-1]
    ndir = s["ndir"]
    lsum = aggregate(cc, ndir, s["mgm"], p1, p2)
    lab = torch.arange(L, device=cc.device)
    in_win = (lab >= lo) & (lab <= hi)
    S = torch.where(in_win, lsum, 0.0)
    del lsum
    if s["fix_overcount"]:
        kappa = torch.tensor(float(ndir - 1), dtype=cc.dtype,
                             device=cc.device)
        S = S - kappa * torch.where(in_win, cc, INF)
    S = torch.where(in_win, S, INF)
    cand = torch.where(torch.isfinite(S), S, INF)
    o = cand.argmin(-1)
    cost = cand.amin(-1).float()
    disp = (o + gmin).float()
    if s["refinement"] == "vfit":
        oc = o.clamp(1, max(L - 3, 1))
        taps = S.gather(-1, (oc[..., None] + torch.arange(-1, 2, device=o.device))
                        .clamp(0, L - 1)).float()
        vm, dx = _vfit(taps[..., 0], taps[..., 1], taps[..., 2])
        ok = (o - 1 >= lo) & (o + 2 <= hi)
        disp = torch.where(ok, (o.float() + dx) + float(gmin), disp)
        cost = torch.where(ok, vm, cost)
    return disp, cost


def leftright(d_left, d_right, tau: float):
    """mgm.cc:68-91: NaN where the right disparity at round(x + d) does
    not bring x back within tau (a NaN there passes)."""
    W = d_left.shape[-1]
    x = torch.arange(W, dtype=torch.float32, device=d_left.device)
    t = x + d_left
    lx = torch.sign(t) * torch.floor(t.abs() + 0.5)
    ok = (lx >= 0) & (lx < W)
    rdx = d_right.gather(-1, torch.nan_to_num(lx).clamp(0, W - 1).long())
    bad = (lx + rdx - x).abs() > torch.tensor(tau, device=d_left.device)
    return torch.where(ok & ~bad, d_left, float("nan"))


# ---------------------------------------------------------- pipeline ----

def _scrub(a: np.ndarray, device):
    t = torch.as_tensor(np.ascontiguousarray(a)).to(device).to(torch.float32)
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


def disparity(us: np.ndarray, vs: np.ndarray, settings: dict, *,
              device="cuda", dtype=torch.float32, plane_chunk: int = 8):
    """The left disparity after the LR check and its cost, float32
    numpy (K, H, W) each, of the K pairs (K, H, W, C) us, vs."""
    s = settings_of(settings)
    us, vs = np.asarray(us), np.asarray(vs)
    K, H, W, C = us.shape
    dmin, dmax = s["dmin"], s["dmax"]
    L = dmax - dmin + 1
    nsides = 2 if s["test_lr"] else 1
    # side 0 matches u against v over dmin..dmax, side 1 v against u
    # over -dmax..-dmin (mgm.cc:368): both windows span every label
    gmins = (dmin, -dmax)
    f32 = dict(dtype=dtype, device=device)
    p1 = torch.tensor(s["p1"] * C, **f32)
    p2 = torch.tensor(s["p2"] * C, **f32)
    planes = [(k, side) for k in range(K) for side in range(nsides)]
    disp = torch.empty((K, nsides, H, W), device=device)
    cost = torch.empty((K, nsides, H, W), device=device)
    for c0 in range(0, len(planes), plane_chunk):
        chunk = planes[c0:c0 + plane_chunk]
        by_side = {}
        for k, side in chunk:
            by_side.setdefault(side, []).append(k)
        for side, ks in by_side.items():
            vols = []
            for k in ks:
                a = _scrub(us[k], device).to(dtype)
                b = _scrub(vs[k], device).to(dtype)
                if side:
                    a, b = b, a
                vols.append(cost_volume(a, b, gmins[side], 0, L - 1, s, L))
            d, c = solve(torch.stack(vols), 0, L - 1, gmins[side], s, p1, p2)
            del vols
            disp[ks, side], cost[ks, side] = d, c
    left = disp[:, 0]
    if nsides == 2:
        left = leftright(disp[:, 0], disp[:, 1], s["lr_tau"])
    return {"disp": left.cpu().numpy(), "cost": cost[:, 0].cpu().numpy()}
