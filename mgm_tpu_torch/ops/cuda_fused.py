"""The fused path's two kernels (counterpart of mgm_tpu/ops/pallas_fused.py).

For each kernel this module holds the ctypes binding, the wrapper, the
plain PyTorch version and a launch counter:

  K1 `fused_wavefront` (csrc/fused_wavefront.cu) replaces
     pallas_fused._kernel: one scan direction of the fused cost + MGM
     recursion over every (side x space) plane of a launch, for every
     pointwise cost family, the SGM or truncated-linear (FH) potential,
     optional edge weights, constant or per-pixel label windows (with
     the FH window restriction) and a batch of image pairs, in one
     launch: one or more thread-block clusters a (pair, plane), the
     rows in bands dealt to the CTAs in turn (`k1_plan`), a warp a row
     (two for L <= 48), the fronts stepped inside the kernel, each row
     waiting only for its neighbour rows' counts of finished fronts.
  K2 `wta` (csrc/wta.cu) replaces pallas_fused._wta_kernel: the sum of
     the spaces, the windowed winner-take-all and optionally the four
     S taps of the subpixel fits, for a batch of pairs: persistent CTAs
     walk runs of consecutive pixels (`k2_plan`), each run's span of
     every space brought into a ring of shared-memory stages by bulk
     copies, summed there and scanned by a group of lanes a pixel.
  K4 `fused_block` (csrc/fused_block.cu) replaces
     pallas_fused._block_kernel: G scan steps of one K1 launch on one
     rank's band of rows under row sharding (parallel/fused_shard.py),
     the ring carried from block to block, rows beyond the band read
     from the neighbour's halo track and the band's edge row shipped.
     It is K1's kernel with the template flag BAND, one launch a block
     (`k4_plan` sizes it from the band's rows), with K1's arithmetic at
     every pixel; `bind_block` builds its fixed arguments once for a
     run of blocks.

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
plane space * N + side; K1 runs every pair's clusters in its one
launch, K2 takes side n's window from entry n % nsides of its table.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
from .common import INF, shift_fill
from .cuda_cost import MODES, pointwise_cost
from .wavefront import SMEM_PER_CTA, _fh_msg, _gdone, _sgm_msg, _sms

# the limits of csrc/mgm_kernels.h
MAX_PLANES, MAX_RECS, MAX_COMBOS, MAX_RANKS = 8, 32, 16, 4
MAX_SIDES, MAX_LABELS = 16, 1024
MAX_CLUSTER = 16           # CTAs a cluster (the non-portable size)
BANDS_PER_CTA = 2          # K1's bands a CTA (k1_plan) ...
LONG_SHARE = 80            # ... twice that from this many rows a CTA
SHARE_CAP = 96             # a one-cluster unit's CTAs: one a 96 rows
SPREAD_SMEM = 120_000      # shared memory that leaves a CTA its own SM
K2_RUNS = (32, 16, 8, 4)   # K2's pixels a run: the largest whose ...
K2_STAGES = 2              # ... stages fit a CTA (k2_plan)


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


K1Plan = collections.namedtuple("K1Plan", "cluster ncl rows band smem")


class _K1Plan(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in K1Plan._fields]


class _BandParams(ctypes.Structure):
    _fields_ = ([("w", _WaveParams), ("halo", ctypes.c_void_p),
                 ("ship", ctypes.c_void_p)]
                + [(f, ctypes.c_int) for f in ("r0", "Rl", "out_off",
                                               "out_R", "ship_row", "G",
                                               "step0", "nsteps")])


class _WtaParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("vol", "disp", "cost", "taps")]
        + [(f, ctypes.c_int) for f in ("N", "nsides", "nspaces", "R", "C",
                                       "L")]
        + [(f, ctypes.c_int * MAX_SIDES)
           for f in ("side_gmin", "side_lo", "side_hi")]
        + [(f, ctypes.c_int) for f in ("run", "stages", "smem")])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with its entry points typed and the parameter
    structs checked against the C layout."""
    lib = _build.load()
    for name, structs in (("mgm_fused_wavefront", (_WaveParams, _K1Plan)),
                          ("mgm_fused_block", (_BandParams, _K1Plan)),
                          ("mgm_wta", (_WtaParams,))):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(st) for st in structs]
        if name != "mgm_wta":  # K1's and K4's cross-cluster counts
            fn.argtypes += [ctypes.c_void_p, ctypes.c_ulonglong]
        fn.argtypes += [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name, params in (("mgm_k1_fit", _WaveParams),
                         ("mgm_k4_fit", _BandParams)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(params), ctypes.POINTER(_K1Plan)]
        fn.restype = ctypes.c_int
    for size_name, struct in (("mgm_wave_params_size", _WaveParams),
                              ("mgm_k1_plan_size", _K1Plan),
                              ("mgm_band_params_size", _BandParams),
                              ("mgm_wta_params_size", _WtaParams)):
        size = getattr(lib, size_name)
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(struct):
            raise RuntimeError(f"{size_name}: the C struct is {size()} "
                               f"bytes, the ctypes mirror "
                               f"{ctypes.sizeof(struct)}")
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
    N, R, C, _ = left.shape
    Ml = len(mspecs) * npair
    D = max(lag for lag, _ in combos)
    T = fstep * (C - 1) + slope * (R - 1) + 1
    hist = torch.full((D + 1, Ml, R, L), INF, dtype=torch.float32,
                      device=left.device)
    mins = torch.full((D + 1, Ml, R), INF, dtype=torch.float32,
                      device=left.device)
    return fused_block_plain(
        left, right, out, hist, mins, step0=0, nsteps=T,
        accumulate=accumulate, planes=planes, mspecs=mspecs, combos=combos,
        L=L, slope=slope, fstep=fstep, mgm=mgm, mode=mode, tmax=tmax, p1=p1,
        p2=p2, kappa=kappa, reverse=reverse, use_fh=use_fh, w8=w8,
        lo_px=lo_px, hi_px=hi_px, fh_restrict=fh_restrict, npair=npair)


def _edge_shift(a, roll: int, edge):
    """a (Ml, Rl, ...) with row r taking row r - roll (|roll| <= 1); the
    vacated row takes `edge` (Ml, ...)."""
    if roll > 0:
        return torch.cat([edge[:, None], a[:, :-1]], 1)
    return torch.cat([a[:, 1:], edge[:, None]], 1)


def fused_block_plain(left, right, out, hist, mins, *, step0, nsteps,
                      accumulate, planes, mspecs, combos, L, slope, fstep,
                      mgm, mode, tmax, p1, p2, kappa, reverse, use_fh=False,
                      w8=None, lo_px=None, hi_px=None, fh_restrict=False,
                      npair=1, r0=0, out_off=0, halo=None, ship=None,
                      ship_row=-1, G=None):
    """Plain PyTorch version of K4 (and, over every step of a launch on
    every row, of K1): the scan steps step0 .. step0 + nsteps - 1 of one
    launch of K1's recursion (front t = step, or T - 1 - step backward)
    on a band of rows, the recursion state carried in a ring.

    The launch's arguments are K1's (fused_wavefront_plain); left,
    right, w8 and lo_px/hi_px hold the whole image (R rows), so the
    front map, the border rule and the images use image rows.  The band
    is `hist`'s Rl local rows; local row r is image row r0 + r (r0 < 0
    or rows past R: apron or padding rows, skipped).
    hist/mins: the (D + 1, Ml, Rl, L) ring of recursion fronts and its
      (D + 1, Ml, Rl) minima, front t in slot t % (D + 1), carried from
      block to block (K1's ring).
    out: (Mp / nsides * N, out_R, C, L); local row r writes out row
      r - out_off when that lies in [0, out_R).
    halo: (2G, Ml, L) the ring of the neighbour band's row that this
      band's edge row reads, step s at entry s mod 2G (the tracks of
      the block before and of this one; its minimum is recomputed, min
      being exact in any order), or None: rows outside the band read
      +inf.
    ship: (G, Ml, L), or None: step step0 + u of the block writes local
      row `ship_row` of each recursion into ship[u], the track the
      neighbour band's halo takes.
    Returns `out`."""
    dev = left.device
    N, R, C, _ = left.shape
    planes, mspecs, out_ix = _pair_tables(planes, mspecs, npair,
                                          N // npair)
    Mp, Ml = len(planes), len(mspecs)
    D = max(lag for lag, _ in combos)
    T = fstep * (C - 1) + slope * (R - 1) + 1
    Rl, out_R = hist.shape[2], out.shape[1]
    G = nsteps if G is None else G
    f32 = dict(dtype=torch.float32, device=dev)

    def field(k):
        """Field k of every plane as an int64 tensor."""
        return torch.tensor([p[k] for p in planes], device=dev)

    side = field(0)
    gmin, lo, hi = (field(k)[:, None, None] for k in (1, 2, 3))
    a0, ssgn = field(4)[:, None], field(5)[:, None]
    U, V = left[side], right[side]                 # (Mp, R, C, nch)
    lrows = torch.arange(Rl, device=dev)
    rows = r0 + lrows                              # image rows of the band
    inside = (rows >= 0) & (rows < R)
    rows_c = rows.clamp(0, R - 1)
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

    for u in range(nsteps):
        step = step0 + u
        if step >= T:
            break
        t = T - 1 - step if reverse else step
        num = t - a0 + ssgn * slope * rows          # (Mp, Rl)
        col = num // fstep
        valid = (num >= 0) & (num % fstep == 0) & (col < C) & inside
        colc = col.clamp(0, C - 1)
        u_t = U[pidx, rows_c, colc]                 # (Mp, Rl, nch)
        q = col[..., None] + gmin + lab             # (Mp, Rl, L)
        v_t = V[pidx[..., None], rows_c[:, None], q.clamp(0, C - 1)]
        raw = pointwise_cost(u_t[:, :, None], v_t, mode)
        e = torch.where((q >= 0) & (q < C), raw.clamp(max=tmax), tmax)
        if lo_px is not None:
            # each pixel's own window (pallas_fused.py:860-862)
            win = ((lab >= lo_px[side[:, None], rows_c, colc][..., None])
                   & (lab <= hi_px[side[:, None], rows_c, colc][..., None]))
        else:
            win = in_win
        # all-invalid window -> 0 (mgm_costvolume.h:410-421)
        anyfin = (win & (e < INF)).any(-1, keepdim=True)
        e = torch.where(anyfin, e, 0.0)
        cc = torch.where(win & valid[..., None], e, INF)
        if w8 is not None:
            # each recursion's weights at the pixels being updated
            wt = W8[midx, rows_c, colc[rec_plane]]  # (Ml, Rl, 8)
        # the FH input mask: each recursion's target window
        fh_win = (win.expand(Mp, Rl, L)[rec_plane]
                  if use_fh and fh_restrict and lo_px is not None else None)

        msgs = []
        for ci, (lag, roll) in enumerate(combos):
            slot = (t + lag if reverse else t - lag) % (D + 1)
            f, mn = hist[slot], mins[slot]
            if roll and halo is not None:
                # the band's edge row reads the neighbour's shipped row
                if abs(roll) != 1:
                    raise ValueError(f"a halo serves row rolls of 1, got "
                                     f"{roll}")
                h = halo[(step - lag) % (2 * G)]
                f = _edge_shift(f, roll, h)
                mn = _edge_shift(mn, roll, h.amin(-1))
            elif roll:
                f = shift_fill(f, roll, 1, INF)
                mn = shift_fill(mn, roll, 1, INF)
            mk = mn[..., None]
            if w8 is not None:
                d = wt[midx, lrows, wch[ci][:, None]][..., None]
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
            # the local rows of them that `out` holds (Python ranges: a
            # mask on the card would wait for it every front)
            first = r0 + out_off
            skip = max(0, -(-(first - live.start) // live.step))
            start = live.start + skip * live.step
            live = range(start, min(live.stop, first + out_R), live.step)
            if not live:
                continue
            o = sums[i] if sums[i] is not None else torch.zeros_like(cc[i])
            if fold:
                o = o + kappa * cc[i]
            lr = lrows[live.start - r0:live.stop - r0:live.step]
            cols = col[i, lr]
            o = o[lr]
            if accumulate:
                o = out[out_ix[i], lr - out_off, cols] + o
            out[out_ix[i], lr - out_off, cols] = o
        new = torch.stack(news)
        slot_t = t % (D + 1)
        hist[slot_t] = new
        mins[slot_t] = new.amin(-1)
        if ship is not None:
            ship[u] = new[:, ship_row]
    return out


def _wave_params(name, left, right, out, hist, mins, *, out_rows,
                 accumulate, planes, mspecs, combos, L, slope, fstep, mgm,
                 mode, tmax, p1, p2, kappa, reverse, use_fh, w8, lo_px,
                 hi_px, fh_restrict, npair):
    """K1's parameter block for CUDA tensors (checked against the
    kernel's limits); `out_rows`: the rows of `out`, the ring's rows
    hist.shape[-2]."""
    dev = left.device
    N, R, C, nch = left.shape
    Mp, Ml, nco = len(planes), len(mspecs), len(combos)
    ns = N // npair if npair >= 1 else 0
    if (Mp > MAX_PLANES or Ml > MAX_RECS or nco > MAX_COMBOS
            or not 1 <= mgm <= MAX_RANKS or not 1 <= L <= MAX_LABELS
            or mode not in MODES or slope < 0 or fstep not in (1, 2)
            or not 1 <= npair <= 65535 or ns < 1 or N != npair * ns
            or Mp % ns or any(p[0] != i % ns for i, p in enumerate(planes))
            or (lo_px is None) != (hi_px is None)):
        raise ValueError(f"{name}: outside the kernel's limits "
                         f"(planes {Mp}, recursions {Ml}, combos {nco}, "
                         f"mgm {mgm}, L {L}, mode {mode!r}, slope {slope}, "
                         f"fstep {fstep}, {npair} pairs of {N} sides; the "
                         f"planes space-major, lo/hi both or neither)")
    dtype = torch.int32 if mode == "census" else torch.float32
    if mode in ("btad", "btsd") and nch % 3:
        raise ValueError(f"{name}: BT needs [I, Imin, Imax] blocks, got "
                         f"{nch} channels")
    _check("left", left, (N, R, C, nch), dev, dtype)
    _check("right", right, (N, R, C, nch), dev, dtype)
    _check("out", out, (Mp // ns * N, out_rows, C, L), dev)
    if w8 is not None:
        _check("w8", w8, (N, R, C, 8), dev)
    if lo_px is not None:
        _check("lo_px", lo_px, (N, R, C), dev, torch.int32)
        _check("hi_px", hi_px, (N, R, C), dev, torch.int32)
    D = max(lag for lag, _ in combos)
    rows = hist.shape[-2]
    _check("hist", hist, hist.shape[:-4] + (D + 1, Ml, rows, L), dev)
    _check("mins", mins, hist.shape[:-4] + (D + 1, Ml, rows), dev)

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
    return p


def k1_plan(R: int, L: int, Mp: int, npair: int, sms: int,
            fits=None) -> K1Plan:
    """K1's launch plan for R rows, L labels, Mp planes and npair pairs
    on a card of `sms` SMs: K1Plan(cluster, ncl, rows, band, smem), a
    pure function of its arguments.

    A (pair, plane) unit is ncl clusters of `cluster` CTAs.  Where a
    unit has room for two clusters or more (sms // units CTAs), it takes
    as many as the card holds together with every other unit's, since a
    unit's clusters wait on one another: clusters of MAX_CLUSTER, or,
    for one or two units, of MAX_CLUSTER / 2 with SPREAD_SMEM bytes of
    shared memory so that each CTA has an SM to itself.  `fits(plan)`
    says how many clusters of the plan's shape the card holds at once
    (the kernel's occupancy; None: sms // cluster, one CTA an SM).
    Otherwise a unit is one cluster of up to MAX_CLUSTER CTAs (a launch
    with more clusters than the card holds runs in waves), at least one
    for each SHARE_CAP rows.  The rows come in bands of `band` rows,
    BANDS_PER_CTA of them a CTA, twice that where a CTA's share of the
    rows is LONG_SHARE or more, band b going to the unit's CTA b mod
    (cluster * ncl), so the rows live on a front spread over every CTA;
    a CTA holds `rows` local rows (the last bands may run past the
    image) and `smem` bytes of shared memory, at least two ints a local
    row.  The labels a lane and the warps a CTA follow from L and `rows`
    in the kernel."""
    most_rows = SMEM_PER_CTA // 8
    if not (1 <= L <= MAX_LABELS and 1 <= R <= MAX_CLUSTER * most_rows
            and 1 <= Mp <= MAX_PLANES and 1 <= npair <= 65535
            and sms >= 1):
        raise ValueError(f"k1_plan: {R} rows, L {L}, {Mp} planes, {npair} "
                         f"pairs, {sms} SMs")

    def shape(cluster, ncl, spread):
        nc = cluster * ncl
        m = BANDS_PER_CTA * (2 if R >= LONG_SHARE * nc else 1)
        band = -(-R // (nc * m))
        while band > 1 and -(-R // band) < nc:
            band -= 1
        rows = -(-(-(-R // band)) // nc) * band
        return K1Plan(cluster=cluster, ncl=ncl, rows=rows, band=band,
                      smem=max(8 * rows, SPREAD_SMEM if spread else 0))

    units = Mp * npair
    budget = max(1, sms // units)
    if min(budget, R) >= 2 * MAX_CLUSTER:
        spread = units <= 2
        cluster = MAX_CLUSTER // 2 if spread else MAX_CLUSTER
        for ncl in range(min(budget, R) // cluster, 1, -1):
            plan = shape(cluster, ncl, spread)
            held = fits(plan) if fits is not None else sms // cluster
            if units * ncl <= held:
                return plan
    cluster = max(min(MAX_CLUSTER, R, max(budget, -(-R // SHARE_CAP))),
                  -(-R // most_rows))
    return shape(cluster, 1, False)


# K1's occupancy queries (fused_wavefront), by instance and CTA shape
_FITS: dict = {}


def fused_wavefront(left, right, out, *, accumulate, planes, mspecs, combos,
                    L, slope, fstep, mgm, mode, tmax, p1, p2, kappa, reverse,
                    use_fh=False, w8=None, lo_px=None, hi_px=None,
                    fh_restrict=False, npair=1):
    """K1: one scan direction of the fused recursion (arguments as in
    fused_wavefront_plain).  CPU tensors take the plain version; CUDA
    tensors launch csrc/fused_wavefront.cu once, on the current stream,
    with k1_plan's sizes for the shape and the card; a launch the card
    refuses raises."""
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
    N, R = left.shape[:2]
    D = max(lag for lag, _ in combos)
    hist = torch.empty((npair, D + 1, len(mspecs), R, L),
                       dtype=torch.float32, device=dev)
    mins = torch.empty((npair, D + 1, len(mspecs), R), dtype=torch.float32,
                       device=dev)
    p = _wave_params("fused_wavefront", left, right, out, hist, mins,
                     out_rows=R, **kw)
    inst = (dev.index, mode, bool(use_fh), w8 is not None,
            lo_px is not None or npair > 1, L)

    def fits(pl):  # the card's occupancy for this instance and shape
        key = inst + (pl.cluster, pl.rows, pl.smem)
        if key not in _FITS:
            _FITS[key] = _lib().mgm_k1_fit(ctypes.byref(p),
                                           ctypes.byref(_K1Plan(*pl)))
        return _FITS[key]

    with torch.cuda.device(dev):
        plan = k1_plan(R, L, len(planes), npair, _sms(dev.index), fits)
        gdone, epoch = (_gdone(dev, npair * len(planes) * R)
                        if plan.ncl > 1 else (None, 0))
        err = _lib().mgm_fused_wavefront(
            ctypes.byref(p), ctypes.byref(_K1Plan(*plan)),
            None if gdone is None else gdone.data_ptr(), epoch,
            _stream(dev))
    if err:
        why = ("no cluster of this size fits the card" if err == -1
               else f"CUDA error {err}")
        raise RuntimeError(f"fused_wavefront: {why}: {plan} for {npair} "
                           f"pair(s) of {N // npair} sides, {R}x"
                           f"{left.shape[2]}, L={L}, {len(planes)} planes")
    fused_wavefront.launches += 1
    return out


fused_wavefront.launches = 0


# ---------------------------------------------------------------- K4 ----

def band_rows(r0: int, Rl: int, R: int) -> tuple[int, int]:
    """The rows K4 runs on a band of Rl local rows whose local row 0 is
    image row r0, in an image of R rows: (lo, n), the local rows lo ..
    lo + n - 1 that lie in the image (csrc/fused_wavefront.cuh
    row_map); aprons above row 0 and the last band's padding are never
    run and never read."""
    lo = max(0, -r0)
    return lo, min(Rl, R - r0) - lo


def k4_plan(rows: int, L: int, Mp: int, sms: int, share: int = 1,
            fits=None) -> K1Plan:
    """K4's launch plan for a band's `rows` rows in the image (band_rows),
    L labels and Mp planes of one pair, a pure function of its
    arguments: K1's plan (k1_plan) on the share of the card's `sms` SMs
    that each of `share` ranks gets when their blocks run on the card at
    once, so that every rank's clusters fit it together (`fits`, the
    kernel's occupancy on the whole card, is divided alike).  A shape
    the card cannot hold raises: rows beyond the kernel, or a cluster
    the card holds none of."""
    if not 1 <= share <= sms:
        raise ValueError(f"k4_plan: {share} ranks on a card of {sms} SMs")
    held = None if fits is None else (lambda pl: fits(pl) // share)
    plan = k1_plan(rows, L, Mp, 1, sms // share, held)
    if fits is not None and fits(plan) < 1:
        raise ValueError(f"k4_plan: the card holds no cluster of {plan} for "
                         f"{rows} rows, L {L}, {Mp} planes")
    return plan


def _k4_launcher(left, right, out, hist, mins, *, nsteps, G, accumulate,
                 planes, mspecs, combos, L, slope, fstep, mgm, mode, tmax,
                 p1, p2, kappa, reverse, use_fh=False, w8=None, lo_px=None,
                 hi_px=None, fh_restrict=False, r0=0, out_off=0, halo=None,
                 ship=None, ship_row=-1, share=1):
    """K4 on CUDA tensors for a run of blocks on one band: the parameter
    block, the plan (k4_plan) and the occupancy query made once; returns
    step(step0), which launches the block of steps step0 .. step0 +
    nsteps - 1 on the current stream of the tensors' card."""
    dev = left.device
    if dev.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {dev}")
    Ml, Rl = len(mspecs), hist.shape[-2]
    D = max(lag for lag, _ in combos)
    _, R, C, _ = left.shape
    T = fstep * (C - 1) + slope * (R - 1) + 1
    _, nr = band_rows(r0, Rl, R)
    if (not 0 < nsteps <= G or G < D or nr < 1 or hist.ndim != 4
            or not -1 <= ship_row < Rl or (ship is None) != (ship_row < 0)):
        raise ValueError(f"fused_block: {nsteps} steps of a {G}-step block "
                         f"(lags up to {D}), {Rl} band rows from image row "
                         f"{r0} ({nr} in the image), ship row {ship_row}")
    if halo is not None:
        _check("halo", halo, (2 * G, Ml, L), dev)
    if ship is not None:
        _check("ship", ship, (G, Ml, L), dev)
    w = _wave_params("fused_block", left, right, out, hist, mins,
                     out_rows=out.shape[1], accumulate=accumulate,
                     planes=planes, mspecs=mspecs, combos=combos, L=L,
                     slope=slope, fstep=fstep, mgm=mgm, mode=mode, tmax=tmax,
                     p1=p1, p2=p2, kappa=kappa, reverse=reverse,
                     use_fh=use_fh, w8=w8, lo_px=lo_px, hi_px=hi_px,
                     fh_restrict=fh_restrict, npair=1)
    p = _BandParams(w=w, halo=None if halo is None else halo.data_ptr(),
                    ship=None if ship is None else ship.data_ptr(), r0=r0,
                    Rl=Rl, out_off=out_off, out_R=out.shape[1],
                    ship_row=ship_row, G=G, step0=0, nsteps=nsteps)
    lib = _lib()
    inst = ("k4", dev.index, mode, bool(use_fh), w8 is not None,
            lo_px is not None, L)

    def fits(pl):  # the card's occupancy for this instance and shape
        key = inst + (pl.cluster, pl.rows, pl.smem)
        if key not in _FITS:
            _FITS[key] = lib.mgm_k4_fit(ctypes.byref(p),
                                        ctypes.byref(_K1Plan(*pl)))
        return _FITS[key]

    with torch.cuda.device(dev):
        plan = k4_plan(nr, L, len(planes), _sms(dev.index), share, fits)
    kplan = _K1Plan(*plan)
    # the parameter block holds raw pointers: the tensors live as long as
    # the launcher (a caller may drop its own references between blocks)
    tensors = (left, right, out, hist, mins, w8, lo_px, hi_px, halo, ship)

    def step(step0: int) -> None:
        if not 0 <= step0 < T:
            raise ValueError(f"fused_block: step {step0} of {T}")
        p.step0 = step0
        with torch.cuda.device(dev):
            gdone, epoch = (_gdone(dev, len(planes) * nr)
                            if plan.ncl > 1 else (None, 0))
            err = lib.mgm_fused_block(
                ctypes.byref(p), ctypes.byref(kplan),
                None if gdone is None else gdone.data_ptr(), epoch,
                _stream(dev))
        if err:
            why = ("no cluster of this size fits the card" if err == -1
                   else f"CUDA error {err}")
            raise RuntimeError(f"fused_block: {why}: {plan} for {nr} of "
                               f"{Rl} band rows from image row {r0}, "
                               f"{R}x{C}, L={L}, {len(planes)} planes, "
                               f"steps {step0} + {nsteps}")
        fused_block.launches += 1

    step.tensors = tensors
    return step


def fused_block(left, right, out, hist, mins, *, step0, nsteps, G,
                accumulate, planes, mspecs, combos, L, slope, fstep, mgm,
                mode, tmax, p1, p2, kappa, reverse, use_fh=False, w8=None,
                lo_px=None, hi_px=None, fh_restrict=False, r0=0, out_off=0,
                halo=None, ship=None, ship_row=-1, share=1):
    """K4: G scan steps of one K1 launch on a band of rows, the
    recursion's ring carried (arguments as in fused_block_plain, one
    image pair; G >= the deepest lag, nsteps <= G; `share`: the ranks
    whose blocks run on the card at once, k4_plan).  CPU tensors take
    the plain version; CUDA tensors launch csrc/fused_block.cu once on
    the current stream of the tensors' card, the block's fronts stepped
    inside the kernel; a launch the card refuses raises, and it never
    falls back to the plain version.  A run of blocks on one band takes
    bind_block, which builds the launch once."""
    kw = dict(nsteps=nsteps, G=G, accumulate=accumulate, planes=planes,
              mspecs=mspecs, combos=combos, L=L, slope=slope, fstep=fstep,
              mgm=mgm, mode=mode, tmax=tmax, p1=p1, p2=p2, kappa=kappa,
              reverse=reverse, use_fh=use_fh, w8=w8, lo_px=lo_px,
              hi_px=hi_px, fh_restrict=fh_restrict, r0=r0, out_off=out_off,
              halo=halo, ship=ship, ship_row=ship_row)
    if left.device.type == "cpu":
        return fused_block_plain(left, right, out, hist, mins, step0=step0,
                                 **kw)
    _k4_launcher(left, right, out, hist, mins, share=share, **kw)(step0)
    return out


fused_block.launches = 0


def bind_block(kernel, left, right, out, hist, mins, *, share=1, **kw):
    """`kernel` (K4, fused_block, or its plain version) with every
    argument but the block's first step bound, for a run of blocks on
    one band: returns step(step0).  K4 on CUDA tensors builds its
    parameter block, plan and occupancy query once (`share` as for
    fused_block); anything else is called with the arguments as they
    are."""
    if kernel is fused_block and left.device.type == "cuda":
        return _k4_launcher(left, right, out, hist, mins, share=share, **kw)

    def step(step0: int) -> None:
        kernel(left, right, out, hist, mins, step0=step0, **kw)

    return step


# ---------------------------------------------------------------- K2 ----

K2Plan = collections.namedtuple("K2Plan", "run stages smem")


def k2_bytes(run: int, stages: int, nspaces: int, L: int) -> int:
    """Shared memory of a K2 CTA (csrc/wta.cu k2_bytes): two mbarriers
    a stage, `stages` stages of nspaces spans of run * L floats (3 words
    of room for a span's offset from a 16-byte boundary, rounded up to
    16 bytes), and the table of sums, a row of L | 1 words a pixel."""
    span = (run * L + 3 + 3) & ~3
    return 16 * stages + 4 * (stages * nspaces * span + run * (L | 1))


def k2_plan(L: int, nspaces: int) -> K2Plan:
    """K2's launch plan: the largest run of K2_RUNS pixels whose
    K2_STAGES stages and table of sums fit a CTA's SMEM_PER_CTA bytes; a
    pure function of (L, nspaces)."""
    if not 1 <= L <= MAX_LABELS or not 1 <= nspaces <= 5:
        raise ValueError(f"k2_plan: L {L}, {nspaces} spaces")
    for run in K2_RUNS:
        smem = k2_bytes(run, K2_STAGES, nspaces, L)
        if smem <= SMEM_PER_CTA:
            return K2Plan(run=run, stages=K2_STAGES, smem=smem)
    raise ValueError(f"k2_plan: L {L} x {nspaces} spaces needs more than "
                     f"{SMEM_PER_CTA} bytes of shared memory")


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
    tensors launch csrc/wta.cu: persistent CTAs walk runs of
    k2_plan(L, nspaces).run pixels, their spans brought into shared
    memory by bulk copies."""
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
    plan = k2_plan(L, nspaces)
    disp = torch.empty((N, R, C), dtype=torch.float32, device=dev)
    cost = torch.empty((N, R, C), dtype=torch.float32, device=dev)
    taps = (torch.empty((N, R, 4, C), dtype=torch.float32, device=dev)
            if want_taps else None)
    p = _WtaParams(vol=vol.data_ptr(), disp=disp.data_ptr(),
                   cost=cost.data_ptr(),
                   taps=None if taps is None else taps.data_ptr(), N=N,
                   nsides=ns, nspaces=nspaces, R=R, C=C, L=L,
                   **plan._asdict())
    for n, (gmin, lo, hi) in enumerate(sides):
        p.side_gmin[n], p.side_lo[n], p.side_hi[n] = gmin, lo, hi
    err = _lib().mgm_wta(ctypes.byref(p), _stream(dev))
    if err:
        raise RuntimeError(f"wta: CUDA error {err}")
    wta.launches += 1
    return (disp, cost, taps) if want_taps else (disp, cost)


wta.launches = 0
