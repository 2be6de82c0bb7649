"""The fused path's two kernels (counterpart of mgm_tpu/ops/pallas_fused.py).

For each kernel this module holds the ctypes binding, the wrapper, the
plain PyTorch version and a launch counter:

  K1 `fused_wavefront` (csrc/fused_wavefront.cu) replaces
     pallas_fused._kernel: one scan direction of the fused cost + MGM
     recursion over every (side x space) plane of a launch, for every
     pointwise cost family, the SGM or truncated-linear (FH) potential,
     optional edge weights, constant or per-pixel label windows (with
     the FH window restriction) and a batch of image pairs.
  K2 `wta` (csrc/wta.cu) replaces pallas_fused._wta_kernel: the sum of
     the spaces, the windowed winner-take-all and optionally the four
     S taps of the subpixel fits, for a batch of pairs.

The per-label cost and the messages are defined once on each side:
csrc/mgm_device.cuh on the card (shared with K5 and K8), and
cuda_cost.pointwise_cost, wavefront._sgm_msg and wavefront._fh_msg in
the plain versions.

A wrapper runs the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises.  `launches`
counts kernel launches (never plain runs), so a run can show that its
main path went through the kernels.

Layouts differ from the TPU's: images stay unskewed, (N, R, C, nch)
per side, and K1 writes the image-layout volume (Mp, R, C, L), plane
i = space_index * N + side.  Pixel (r, col) of a plane lies on front
t = fstep*col + a0 - ssgn*slope*r, so a launch has
T = fstep*(C-1) + slope*(R-1) + 1 fronts:

  space   slope   fstep   a0              ssgn
  A       s       1       0               -1
  B       s       1       s*(R-1)         +1
  V       0       1       0               -1
  PA      1       2       0               -1
  PB      1       2       R-1             +1

(s = 1 or 2).  In the parity spaces a row sits out every other front;
the TPU packs the live half-rows into lanes, the port keeps the image
layout and skips them.

A batch of `npair` image pairs shares one table of (side, space)
planes: the images are (npair * nsides, R, C, nch), pair-major, and the
volume keeps the space-major order over all N = npair * nsides sides,
plane space * N + side; K1 runs the pair as a grid axis (a batch
launches as many fronts as one pair), K2 takes side n's window from
entry n % nsides of its table.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .common import INF, shift_fill
from .cuda_cost import MODES, pointwise_cost
from .wavefront import _fh_msg, _sgm_msg

# the limits of csrc/mgm_kernels.h
MAX_PLANES, MAX_RECS, MAX_COMBOS, MAX_RANKS = 8, 32, 16, 4
MAX_SIDES, MAX_LABELS = 16, 1024


class _WaveParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("left", "right", "w8", "lo_px",
                                        "hi_px", "out", "hist", "mins")]
        + [(f, ctypes.c_int) for f in ("R", "C", "L", "nch", "Mp", "Ml",
                                       "D", "npair", "nsides", "slope",
                                       "fstep", "mgm", "mode", "use_fh",
                                       "accumulate", "reverse",
                                       "fh_restrict")]
        + [(f, ctypes.c_float) for f in ("tmax", "p1", "p2", "kappa",
                                         "inv_nw")]
        + [(f, ctypes.c_int * MAX_PLANES)
           for f in ("plane_gmin", "plane_lo", "plane_hi", "plane_a0")]
        + [(f, ctypes.c_int8 * MAX_PLANES)
           for f in ("plane_side", "plane_ssgn", "plane_fold", "plane_nrec")]
        + [("plane_recs", (ctypes.c_uint8 * MAX_RECS) * MAX_PLANES),
           ("rec_ranks", (ctypes.c_uint8 * MAX_RANKS) * MAX_RECS),
           ("rec_wch", (ctypes.c_uint8 * MAX_RANKS) * MAX_RECS),
           ("rec_border", ctypes.c_uint8 * MAX_RECS),
           ("combo_lag", ctypes.c_int8 * MAX_COMBOS),
           ("combo_roll", ctypes.c_int8 * MAX_COMBOS)])


class _WtaParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("vol", "disp", "cost", "taps")]
        + [(f, ctypes.c_int) for f in ("N", "nsides", "nspaces", "R", "C",
                                       "L")]
        + [(f, ctypes.c_int * MAX_SIDES)
           for f in ("side_gmin", "side_lo", "side_hi")])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with its entry points typed and the parameter
    structs checked against the C layout."""
    lib = _build.load()
    for name, size_name, struct in (
            ("mgm_fused_wavefront", "mgm_wave_params_size", _WaveParams),
            ("mgm_wta", "mgm_wta_params_size", _WtaParams)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = getattr(lib, size_name)
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: C struct is {size()} bytes, the "
                               f"ctypes mirror {ctypes.sizeof(struct)}")
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype=torch.float32) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name}: want a contiguous {dtype} {shape} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------- K1 ----

def _valid_rows(t: int, a0: int, ssgn: int, slope: int, C: int, R: int,
                fstep: int) -> range:
    """The rows with a pixel on front t inside the image: those whose
    num = t - a0 + ssgn*slope*r is a multiple of fstep with
    0 <= num / fstep < C (fstep 2 only at slope 1)."""
    base, top = t - a0, fstep * (C - 1)
    if slope == 0:
        live = 0 <= base <= top and base % fstep == 0
        return range(R if live else 0)
    if ssgn < 0:   # num = base - slope*r
        r0, r1 = -((top - base) // slope), base // slope + 1
    else:          # num = base + slope*r
        r0, r1 = -(base // slope), (top - base) // slope + 1
    r0 = max(r0, 0)
    if fstep == 2:  # slope 1: num's parity is (base + r)'s
        r0 += (base + r0) % 2
    return range(r0, min(r1, R), fstep)


def _pair_tables(planes, mspecs, npair: int, nsides: int):
    """Every pair's copy of one pair's planes and recursions, and the
    output plane of each copy: pair k's plane i (space-major, i =
    space * nsides + side) lands at (i - side) * npair + k * nsides +
    side, the volume's space-major order over all npair * nsides
    sides."""
    Mp = len(planes)
    out_ix = [(i - p[0]) * npair + k * nsides + p[0]
              for k in range(npair) for i, p in enumerate(planes)]
    planes = [(p[0] + k * nsides,) + tuple(p[1:])
              for k in range(npair) for p in planes]
    mspecs = [(ms[0] + k * Mp,) + tuple(ms[1:])
              for k in range(npair) for ms in mspecs]
    return planes, mspecs, out_ix


def fused_wavefront_plain(left, right, out, *, accumulate, planes, mspecs,
                          combos, L, slope, fstep, mgm, mode, tmax, p1, p2,
                          kappa, reverse, use_fh=False, w8=None, lo_px=None,
                          hi_px=None, fh_restrict=False, npair=1):
    """Plain PyTorch version of K1: a loop over fronts with tensor ops
    over (planes or recursions, R, L), in the fused kernel's order of
    operations (pallas_fused.py:834-949), not the dense solver's.

    left/right: (N, R, C, nch) images, N = npair * nsides sides,
      pair-major: float32 (ad, sd), int32 census words, or BT's
      [I, Imin, Imax] float32 blocks.
    out: the (Mp / nsides * N, R, C, L) volume the launch writes, or
      adds onto with `accumulate` (the backward launch onto the forward
      one's output).
    planes: (side, gmin, lo, hi, a0, ssgn, fold) per output plane of
      one pair, space-major (plane i = space * nsides + side).
    slope, fstep: the launch space's front map (module docstring).
    mspecs: (plane, ranks, border, wch) per recursion; ranks index
      `combos`, border = (need_left, need_right, need_top, need_bottom),
      wch = the weight channel of each coupled dep.
    combos: (lag, roll) per distinct message source: the front t -+ lag,
      row r - roll.
    mode: a cuda_cost.MODES family; tmax: the truncation.
    use_fh: the truncated-linear potential (FH messages), else SGM.
    w8: (N, R, C, 8) float32 edge weights of each side, or None.
    lo_px/hi_px: (N, R, C) int32 per-pixel label windows, or None (the
      planes' constant lo/hi); fh_restrict masks each FH message's input
      with the target pixel's window.
    npair: the pairs of the batch, each with the same planes.
    Returns `out`."""
    dev = left.device
    N, R, C, _ = left.shape
    planes, mspecs, out_ix = _pair_tables(planes, mspecs, npair,
                                          N // npair)
    Mp, Ml = len(planes), len(mspecs)
    D = max(lag for lag, _ in combos)
    T = fstep * (C - 1) + slope * (R - 1) + 1
    f32 = dict(dtype=torch.float32, device=dev)

    def field(k):
        """Field k of every plane as an int64 tensor."""
        return torch.tensor([p[k] for p in planes], device=dev)

    side = field(0)
    gmin, lo, hi = (field(k)[:, None, None] for k in (1, 2, 3))
    a0, ssgn = field(4)[:, None], field(5)[:, None]
    U, V = left[side], right[side]                 # (Mp, R, C, nch)
    rows = torch.arange(R, device=dev)
    lab = torch.arange(L, device=dev)
    in_win = (lab >= lo) & (lab <= hi)             # (Mp, 1, L)
    pidx = torch.arange(Mp, device=dev)[:, None]
    rec_plane = torch.tensor([ms[0] for ms in mspecs], device=dev)
    # 0-dim tensors: products and sums with them round in float32, as
    # the kernel's; a true division (CUDA would turn a division by a
    # Python number into a reciprocal multiply)
    p1f, p2f = torch.tensor(p1, **f32), torch.tensor(p2, **f32)
    mgm_div = torch.tensor(float(mgm), **f32)
    halve = mgm == 2 and not use_fh and w8 is None
    if w8 is not None:
        W8 = w8[side[rec_plane]]                   # (Ml, R, C, 8)
        # per combo: the weight channel of the dep it is in each
        # recursion (0 where it is not: that message is never read)
        wch = torch.tensor([[ms[3][ms[1].index(ci)] if ci in ms[1] else 0
                             for ms in mspecs] for ci in range(len(combos))],
                           device=dev)
        midx = torch.arange(Ml, device=dev)[:, None]
    hist = [(torch.full((Ml, R, L), INF, **f32),
             torch.full((Ml, R), INF, **f32))] * D

    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        num = t - a0 + ssgn * slope * rows          # (Mp, R)
        col = num // fstep
        valid = (num >= 0) & (num % fstep == 0) & (col < C)
        colc = col.clamp(0, C - 1)
        u_t = U[pidx, rows, colc]                   # (Mp, R, nch)
        q = col[..., None] + gmin + lab             # (Mp, R, L)
        v_t = V[pidx[..., None], rows[:, None], q.clamp(0, C - 1)]
        raw = pointwise_cost(u_t[:, :, None], v_t, mode)
        e = torch.where((q >= 0) & (q < C), raw.clamp(max=tmax), tmax)
        if lo_px is not None:
            # each pixel's own window (pallas_fused.py:860-862)
            win = ((lab >= lo_px[side[:, None], rows, colc][..., None])
                   & (lab <= hi_px[side[:, None], rows, colc][..., None]))
        else:
            win = in_win
        # all-invalid window -> 0 (mgm_costvolume.h:410-421)
        anyfin = (win & (e < INF)).any(-1, keepdim=True)
        e = torch.where(anyfin, e, 0.0)
        cc = torch.where(win & valid[..., None], e, INF)
        if w8 is not None:
            # each recursion's weights at the pixels being updated
            wt = W8[midx, rows, colc[rec_plane]]    # (Ml, R, 8)
        # the FH input mask: each recursion's target window
        fh_win = (win.expand(Mp, R, L)[rec_plane]
                  if use_fh and fh_restrict and lo_px is not None else None)

        msgs = []
        for ci, (lag, roll) in enumerate(combos):
            f, mn = hist[lag - 1]
            if roll:
                f = shift_fill(f, roll, 1, INF)
                mn = shift_fill(mn, roll, 1, INF)
            mk = mn[..., None]
            if w8 is not None:
                d = wt[midx, rows, wch[ci][:, None]][..., None]   # (Ml, R, 1)
                p1w, p2w = d * p1f, d * p2f
            else:
                p1w, p2w = p1f, p2f
            msgs.append(_fh_msg(f, mk, p1w, p2w, fh_win) if use_fh
                        else _sgm_msg(f, mk, p1w, p2w))

        news = []
        sums = [None] * Mp
        for m, (pi, ranks, border, _) in enumerate(mspecs):
            if halve:
                # update_cost2 halves each term (mgm_core.cc:83-84)
                em = msgs[ranks[0]][m] * 0.5 + msgs[ranks[1]][m] * 0.5
            else:
                em = msgs[ranks[0]][m]
                for k in range(1, mgm):
                    em = em + msgs[ranks[k]][m]
                if mgm > 1:
                    em = em / mgm_div
            need_l, need_r, need_t, need_b = border
            ci = col[pi]
            interior = (ci >= (1 if need_l else 0)) & (ci < C)
            if need_r:
                interior &= ci <= C - 2
            if need_t:
                interior &= rows >= 1
            if need_b:
                interior &= rows <= R - 2
            # a select, never a multiply by the mask: messages at the
            # border are inf - inf = NaN
            new_m = torch.where(interior[:, None], cc[pi] + em, cc[pi])
            news.append(new_m)
            sums[pi] = new_m if sums[pi] is None else sums[pi] + new_m

        for i, (_, _, _, _, pa0, pss, fold) in enumerate(planes):
            live = _valid_rows(t, pa0, pss, slope, C, R, fstep)
            if not live:
                continue
            o = sums[i] if sums[i] is not None else torch.zeros_like(cc[i])
            if fold:
                o = o + kappa * cc[i]
            rr = rows[live.start:live.stop:live.step]
            cols = col[i, rr]
            o = o[rr]
            if accumulate:
                o = out[out_ix[i], rr, cols] + o
            out[out_ix[i], rr, cols] = o
        new = torch.stack(news)
        hist = [(new, new.amin(-1))] + hist[:-1]
    return out


def fused_wavefront(left, right, out, *, accumulate, planes, mspecs, combos,
                    L, slope, fstep, mgm, mode, tmax, p1, p2, kappa, reverse,
                    use_fh=False, w8=None, lo_px=None, hi_px=None,
                    fh_restrict=False, npair=1):
    """K1: one scan direction of the fused recursion (arguments as in
    fused_wavefront_plain).  CPU tensors take the plain version; CUDA
    tensors launch csrc/fused_wavefront.cu, T front kernels on the
    current stream."""
    kw = dict(accumulate=accumulate, planes=planes, mspecs=mspecs,
              combos=combos, L=L, slope=slope, fstep=fstep, mgm=mgm,
              mode=mode, tmax=tmax, p1=p1, p2=p2, kappa=kappa,
              reverse=reverse, use_fh=use_fh, w8=w8, lo_px=lo_px,
              hi_px=hi_px, fh_restrict=fh_restrict, npair=npair)
    dev = left.device
    if dev.type == "cpu":
        return fused_wavefront_plain(left, right, out, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_wavefront: unsupported device {dev}")
    N, R, C, nch = left.shape
    Mp, Ml, nco = len(planes), len(mspecs), len(combos)
    ns = N // npair if npair >= 1 else 0
    if (Mp > MAX_PLANES or Ml > MAX_RECS or nco > MAX_COMBOS
            or not 1 <= mgm <= MAX_RANKS or not 1 <= L <= MAX_LABELS
            or mode not in MODES or slope < 0 or fstep < 1
            or not 1 <= npair <= 65535 or ns < 1 or N != npair * ns
            or Mp % ns or any(p[0] != i % ns for i, p in enumerate(planes))
            or (lo_px is None) != (hi_px is None)):
        raise ValueError(f"fused_wavefront: outside the kernel's limits "
                         f"(planes {Mp}, recursions {Ml}, combos {nco}, "
                         f"mgm {mgm}, L {L}, mode {mode!r}, slope {slope}, "
                         f"fstep {fstep}, {npair} pairs of {N} sides; the "
                         f"planes space-major, lo/hi both or neither)")
    dtype = torch.int32 if mode == "census" else torch.float32
    if mode in ("btad", "btsd") and nch % 3:
        raise ValueError(f"fused_wavefront: BT needs [I, Imin, Imax] "
                         f"blocks, got {nch} channels")
    _check("left", left, (N, R, C, nch), dev, dtype)
    _check("right", right, (N, R, C, nch), dev, dtype)
    _check("out", out, (Mp // ns * N, R, C, L), dev)
    if w8 is not None:
        _check("w8", w8, (N, R, C, 8), dev)
    if lo_px is not None:
        _check("lo_px", lo_px, (N, R, C), dev, torch.int32)
        _check("hi_px", hi_px, (N, R, C), dev, torch.int32)
    D = max(lag for lag, _ in combos)
    hist = torch.empty((npair, D + 1, Ml, R, L), dtype=torch.float32,
                       device=dev)
    mins = torch.empty((npair, D + 1, Ml, R), dtype=torch.float32,
                       device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    p = _WaveParams(
        left=left.data_ptr(), right=right.data_ptr(), w8=ptr(w8),
        lo_px=ptr(lo_px), hi_px=ptr(hi_px), out=out.data_ptr(),
        hist=hist.data_ptr(), mins=mins.data_ptr(), R=R, C=C, L=L, nch=nch,
        Mp=Mp, Ml=Ml, D=D, npair=npair, nsides=ns, slope=slope, fstep=fstep,
        mgm=mgm, mode=MODES.index(mode), use_fh=int(use_fh),
        accumulate=int(accumulate), reverse=int(reverse),
        fh_restrict=int(fh_restrict and lo_px is not None), tmax=tmax,
        p1=p1, p2=p2, kappa=kappa, inv_nw=1.0 / nch)
    for i, (side, gmin, lo, hi, a0, ssgn, fold) in enumerate(planes):
        recs = [m for m, spec in enumerate(mspecs) if spec[0] == i]
        p.plane_side[i], p.plane_gmin[i] = side, gmin
        p.plane_lo[i], p.plane_hi[i] = lo, hi
        p.plane_a0[i], p.plane_ssgn[i] = a0, ssgn
        p.plane_fold[i], p.plane_nrec[i] = int(fold), len(recs)
        for k, m in enumerate(recs):
            p.plane_recs[i][k] = m
    for m, (_, ranks, border, wch) in enumerate(mspecs):
        for k, ci in enumerate(ranks):
            p.rec_ranks[m][k] = ci
            p.rec_wch[m][k] = wch[k]
        p.rec_border[m] = sum(1 << b for b, need in enumerate(border)
                              if need)
    for k, (lag, roll) in enumerate(combos):
        p.combo_lag[k], p.combo_roll[k] = lag, roll
    err = _lib().mgm_fused_wavefront(ctypes.byref(p), _stream(dev))
    if err:
        raise RuntimeError(f"fused_wavefront: CUDA error {err}")
    fused_wavefront.launches += 1
    return out


fused_wavefront.launches = 0


# ---------------------------------------------------------------- K2 ----

def wta_plain(vol, *, nspaces, sides, npair=1, want_taps=False):
    """Plain PyTorch version of K2 (pallas_fused.py:211-240).

    vol: (nspaces * N, R, C, L) space-major planes, N = npair *
    len(sides); sides: (gmin, lo, hi) per side of one pair, side n
    taking entry n % len(sides).  Returns (disp, cost), each (N, R, C)
    float32, and with `want_taps` also the (N, R, 4, C) taps: the space
    sum s at clip(oc - 1 + k, 0, L - 1), oc = clip(idx, 1,
    max(L - 3, 1)), the four values the subpixel fits read
    (refine.subpixel_refine_taps)."""
    N = npair * len(sides)
    L = vol.shape[-1]
    lab = torch.arange(L, device=vol.device)
    disps, costs, taps = [], [], []
    for n in range(N):
        gmin, lo, hi = sides[n % len(sides)]
        s = vol[n]
        for si in range(1, nspaces):
            s = s + vol[si * N + n]
        ok = (lab >= lo) & (lab <= hi) & (s < INF) & (s > -INF)
        cand = torch.where(ok, s, INF)
        cost = cand.amin(-1)
        idx = torch.where(cand == cost[..., None], lab, L).amin(-1)
        disps.append((idx + gmin).to(torch.float32))
        costs.append(cost)
        if want_taps:
            oc = idx.clamp(1, max(L - 3, 1))
            pos = (oc[..., None] + torch.arange(-1, 3, device=vol.device))
            taps.append(s.gather(-1, pos.clamp(0, L - 1)).movedim(-1, -2))
    out = (torch.stack(disps), torch.stack(costs))
    return out + (torch.stack(taps),) if want_taps else out


def wta(vol, *, nspaces, sides, npair=1, want_taps=False):
    """K2: sum of the spaces + windowed WTA (+ the taps), arguments and
    results as in wta_plain.  CPU tensors take the plain version; CUDA
    tensors launch csrc/wta.cu."""
    dev = vol.device
    if dev.type == "cpu":
        return wta_plain(vol, nspaces=nspaces, sides=sides, npair=npair,
                         want_taps=want_taps)
    if dev.type != "cuda":
        raise ValueError(f"wta: unsupported device {dev}")
    ns = len(sides)
    N = npair * ns
    if not 1 <= ns <= MAX_SIDES or npair < 1 or vol.ndim != 4:
        raise ValueError(f"wta: {npair} pairs of {ns} sides, volume "
                         f"{tuple(vol.shape)}")
    _, R, C, L = vol.shape
    _check("vol", vol, (nspaces * N, R, C, L), dev)
    disp = torch.empty((N, R, C), dtype=torch.float32, device=dev)
    cost = torch.empty((N, R, C), dtype=torch.float32, device=dev)
    taps = (torch.empty((N, R, 4, C), dtype=torch.float32, device=dev)
            if want_taps else None)
    p = _WtaParams(vol=vol.data_ptr(), disp=disp.data_ptr(),
                   cost=cost.data_ptr(),
                   taps=None if taps is None else taps.data_ptr(), N=N,
                   nsides=ns, nspaces=nspaces, R=R, C=C, L=L)
    for n, (gmin, lo, hi) in enumerate(sides):
        p.side_gmin[n], p.side_lo[n], p.side_hi[n] = gmin, lo, hi
    err = _lib().mgm_wta(ctypes.byref(p), _stream(dev))
    if err:
        raise RuntimeError(f"wta: CUDA error {err}")
    wta.launches += 1
    return (disp, cost, taps) if want_taps else (disp, cost)


wta.launches = 0
