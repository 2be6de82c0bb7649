"""The dense path's kernel (counterpart of mgm_tpu/ops/pallas_wavefront.py).

K5 `wavefront_scan` (csrc/wavefront.cu) replaces pallas_wavefront._kernel:
the MGM recursion over one canonical pass group, SGM or FH, weighted or
not, knight or not.  This module holds its ctypes binding, the wrapper,
the plain PyTorch version and a launch counter.

The TPU's layout kernels _skew_kernel (skew_p) and _unskew_kernel
(unskew_p) have no launch here: K5 reads each pass's costs, weights and
label windows from the image-layout tensors and writes each pass's
aggregated volume in image orientation, through the pass's orientation
map (aggregate.pass_map), so the canonicalisation and the skew are its
address arithmetic.  Their plain versions `skew_plain` (out[a, r,
slope*r + c, b] = x[a, r, c, b], fill elsewhere) and `unskew_plain` (its
inverse) remain: K5's plain version runs the TPU's pipeline through
them.

K5 on a band `wavefront_band` (csrc/wavefront_band.cu, K5's kernel with
the template flag BAND) is the dense recursion of a rank's band of
canonical rows for the mesh path (parallel/halo.py, the counterpart of
mgm_tpu/parallel/halo.py's XLA recursion): one launch a block of G
fronts, the recursion's state in the band's output from block to
block, the band's first row reading the upstream rank's edge row from
a halo ring and its last row writing the ship track; `bind_band` binds
its fixed arguments once for a run of blocks; `wavefront_band_plain` is
its plain version.

A wrapper runs the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises.  `launches`
counts the calls that launched the kernel (never plain runs); one K5
call is one device launch that steps every front of the group inside
the kernel, its size from `k5_plan`; one K5-band call one launch that
steps a block's fronts.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
from .common import INF, fmin3, shift_fill

# the limits of csrc/mgm_kernels.h
MAX_LABELS, MAX_OFFS, MAX_RANKS, MAX_PASSES = 1024, 5, 4, 4

# per skew slope: canonical offset id -> (front lag, needs row shift).
# Slope 2 holds for every pass; slope 1 is valid whenever the NE offset
# (same-front on slope 1) is inactive — axis passes with mgm <= 3 and
# all knight passes — and shortens the chain of fronts by ~30%.
OFF_LAG = {
    2: {0: (1, False), 1: (2, True), 2: (3, True), 3: (1, True),
        4: (4, True)},
    1: {0: (1, False), 1: (1, True), 2: (2, True), 4: (3, True)},
}


class _ScanParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("cc", "out", "mins", "w8", "lo",
                                        "hi", "halo", "halo_m", "ship",
                                        "ship_m")]
        + [(f, ctypes.c_int) for f in ("B", "N", "H", "W", "M", "R", "C",
                                       "L", "slope", "mgm", "knight",
                                       "use_fh", "use_weights",
                                       "fh_restrict")]
        + [(f, ctypes.c_float) for f in ("p1", "p2")]
        + [("noffs", ctypes.c_int),
           ("off_lag", ctypes.c_int * MAX_OFFS),
           ("off_shift", ctypes.c_int * MAX_OFFS),
           ("dir_rank", ctypes.c_int * MAX_RANKS)]
        + [(f, ctypes.c_int * MAX_PASSES) for f in ("origin", "dr", "dc")]
        + [("wch", (ctypes.c_int * MAX_OFFS) * MAX_PASSES)]
        + [(f, ctypes.c_int * MAX_PASSES) for f in ("row0", "col0", "c1")]
        + [(f, ctypes.c_int) for f in ("r0", "t0", "G")])


class _K5Plan(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("ctas", "warps", "smem")]


# K5's launch plan (csrc/mgm_kernels.h K5Plan)
K5Plan = collections.namedtuple("K5Plan", "ctas warps smem")

K5_WARPS = 8   # rows a band: the warps of a CTA
SMEM_PER_CTA = 232_448   # bytes of shared memory a CTA may use
K5_SLACK = 2   # bands a plane group beyond those a front keeps busy


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with this module's entry points typed."""
    lib = _build.load()
    for name in ("mgm_wavefront_scan", "mgm_wavefront_band"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_ScanParams), ctypes.POINTER(_K5Plan),
                       ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("mgm_k5_fit", "mgm_k5b_fit"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_ScanParams), ctypes.POINTER(_K5Plan)]
        fn.restype = ctypes.c_int
    for size_name, st in (("mgm_scan_params_size", _ScanParams),
                          ("mgm_k5_plan_size", _K5Plan)):
        size = getattr(lib, size_name)
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(st):
            raise RuntimeError(f"{size_name}: the C struct is {size()} "
                               f"bytes, the ctypes mirror "
                               f"{ctypes.sizeof(st)}")
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K1's and K5's counts between CTAs that wait on each other: a buffer
# and the last launch's epoch for each (card, stream).  A launch tags
# its counts with a new epoch, so the buffer is zeroed only when it is
# made, and the two kernels may share it (their launches on a stream
# run one after the other)
_GDONE: dict = {}


def _gdone(dev, n: int):
    """(buffer of at least n int64 counts, a new epoch) for a launch on
    the current stream of `dev`."""
    key = (dev.index, _stream(dev))
    buf, epoch = _GDONE.get(key, (None, 0))
    if buf is None or buf.numel() < n or epoch + 1 >= 1 << 32:
        buf, epoch = torch.zeros(n, dtype=torch.int64, device=dev), 0
    _GDONE[key] = (buf, epoch + 1)
    return buf, epoch + 1


def _check(name, t, shape, dtypes, device) -> None:
    if (t.dtype not in dtypes or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name}: want a contiguous {shape} tensor of "
                         f"{[str(d) for d in dtypes]} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


# ------------------------------------------- the TPU's skew, in plain ----

def skew_plain(x: torch.Tensor, fill, slope: int) -> torch.Tensor:
    """The TPU's skew (pallas_wavefront._skew_kernel) in plain PyTorch:
    (A, R, C, B) -> (A, R, T, B), T = C + slope*(R-1),
    out[a, r, slope*r + c, b] = x[a, r, c, b] and `fill` elsewhere."""
    A, R, C, B = x.shape
    T = C + slope * (R - 1)
    out = torch.full((A, R, T, B), fill, dtype=x.dtype, device=x.device)
    for r in range(R):
        out[:, r, slope * r:slope * r + C] = x[:, r]
    return out


def unskew_plain(y: torch.Tensor, C: int, slope: int) -> torch.Tensor:
    """The inverse of skew_plain (pallas_wavefront._unskew_kernel):
    (A, R, T, B) -> (A, R, C, B)."""
    R = y.shape[1]
    return torch.stack([y[:, r, slope * r:slope * r + C] for r in range(R)],
                       1)


# ---------------------------------------------------------------- K5 ----

def _sgm_msg(Lk, mk, p1w, p2w):
    """min(Lk[o], min(Lk[o-1],Lk[o+1])+P1w, minLk+P2w) - minLk
    (mgm_core.cc:74-76,113-116)."""
    vlp1 = torch.minimum(shift_fill(Lk, 1, -1, INF),
                         shift_fill(Lk, -1, -1, INF)) + p1w
    return fmin3(Lk, vlp1, mk + p2w) - mk


def _fh_msg(Lk, mk, p1w, p2w, win):
    """Truncated-linear message by min-plus doubling over the label axis
    (mgm_core.cc:152-163 computed in log2(L) vector steps).  `win`
    restricts the min-convolution's input to the target pixel's label
    window (None: the full axis)."""
    L = Lk.shape[-1]
    M = torch.where(win, Lk, INF) if win is not None else Lk
    s = 1
    while s < L:
        M = torch.minimum(M, shift_fill(M, s, -1, INF) + p1w * s)
        s *= 2
    s = 1
    while s < L:
        M = torch.minimum(M, shift_fill(M, -s, -1, INF) + p1w * s)
        s *= 2
    M = torch.minimum(M, mk + p2w)
    return M - mk


def _front_update(cc_t, deps, wts, win, interior, *, p1f, p2f, mgm_div,
                  dir2off, mgm, use_fh):
    """One front of the recursion, in _front_update's order of
    operations (pallas_wavefront.py:177-221): cc_t (M, n, L) the
    front's costs; deps {offset id: (values (M, n, L), minima (M, n))}
    its neighbours' rows; wts {offset id: (M, n, 1) weights} or None;
    win (M, n, L) the FH input's labels or None; interior (M, n) the
    pixels that aggregate.  Returns (new values, their minima)."""
    msgs = {}
    for off, (f, mk) in deps.items():
        if wts is not None:
            p1w, p2w = wts[off] * p1f, wts[off] * p2f
        else:
            p1w, p2w = p1f, p2f
        mk = mk[..., None]
        msgs[off] = (_fh_msg(f, mk, p1w, p2w, win) if use_fh
                     else _sgm_msg(f, mk, p1w, p2w))
    if mgm == 2 and wts is None and not use_fh:
        # update_cost2 halves each term before summing (mgm_core.cc:83-84)
        e = msgs[dir2off[0]] * 0.5 + msgs[dir2off[1]] * 0.5
    else:
        e = msgs[dir2off[0]]
        for k in range(1, mgm):
            e = e + msgs[dir2off[k]]
        if mgm > 1:
            e = e / mgm_div
    # a select, never a multiply by the mask: border messages may be
    # inf - inf = NaN
    new = torch.where(interior[..., None], cc_t + e, cc_t)
    return new, new.amin(-1)


def _consts(p1, p2, mgm, device):
    """p1, p2 and the TSGM divisor as 0-dim float32 tensors on `device`
    (a true division: CUDA would turn a division by a Python number into
    a reciprocal multiply)."""
    f32 = dict(dtype=torch.float32, device=device)
    return dict(p1f=torch.tensor(p1, **f32), p2f=torch.tensor(p2, **f32),
                mgm_div=torch.tensor(float(mgm), **f32))


def full_border(B: int, C: int) -> tuple:
    """Each pass's (first real canonical row, first real column, real
    columns) of an image with no padding rows."""
    return ((0, 0, C),) * B


def _interior(rows, cols, border, N: int, knight: bool):
    """(M, n) bool: the pixels (rows[j], cols[j]) (global canonical
    coordinates, (n,) each or broadcasting) that aggregate in each plane
    m = b*N + n: below the pass's first real row, and inside its real
    columns but their 1-pixel border (knight passes: two columns on the
    left, none on the right; mgm_core.cc:538-541, with mgm_tpu's shifted
    masks for mesh padding rows, aggregate.py:355-366)."""
    dev = rows.device

    def per_plane(k):
        return torch.tensor([g[k] for g in border], device=dev
                            ).repeat_interleave(N)[:, None]

    row0, col0, c1 = per_plane(0), per_plane(1), per_plane(2)
    lo, hi = (2, 1) if knight else (1, 2)
    return ((rows >= row0 + 1) & (cols >= col0 + lo)
            & (cols <= col0 + c1 - hi))


def _scan_fronts(vol, w_sk, lo_sk, hi_sk, *, C, p1, p2, mgm, dir2off,
                 slope, knight, use_fh, use_weights, fh_restrict,
                 border=None, N=1):
    """The TPU kernel's front loop over a skewed canonical pass group,
    with tensor ops over (M, R, L) (_front_update).  vol: (M, R, T, L)
    skewed costs, updated in place into the aggregated volume; w_sk:
    (n_off*M, R, T, 1) weights per offset rank when use_weights;
    lo_sk/hi_sk: (M, R, T, 1) int32 label windows when fh_restrict;
    border: each pass's (row0, col0, c1), planes b*N + n (None: no
    padding rows)."""
    M, R, T, L = vol.shape
    border = border or full_border(M // N, C)
    dev = vol.device
    f32 = dict(dtype=torch.float32, device=dev)
    offs = sorted(set(dir2off))
    consts = _consts(p1, p2, mgm, dev)
    jj = torch.arange(R, device=dev)
    lab = torch.arange(L, device=dev)
    mins = torch.full((M, R, T), INF, **f32)
    none_f, none_m = (torch.full((M, R, L), INF, **f32),
                      torch.full((M, R), INF, **f32))
    for t in range(T):
        win = None
        if fh_restrict:
            win = ((lab >= lo_sk[:, :, t, 0, None])
                   & (lab <= hi_sk[:, :, t, 0, None]))
        deps, wts = {}, {} if use_weights else None
        for rank, off in enumerate(offs):
            lag, shift = OFF_LAG[slope][off]
            # fronts before the first are never read by an interior pixel
            f, mk = ((vol[:, :, t - lag], mins[:, :, t - lag]) if t >= lag
                     else (none_f, none_m))
            if shift:
                f, mk = shift_fill(f, 1, 1, INF), shift_fill(mk, 1, 1, INF)
            deps[off] = (f, mk)
            if use_weights:
                wts[off] = w_sk[rank * M:(rank + 1) * M, :, t]  # (M, R, 1)
        new, new_min = _front_update(
            vol[:, :, t], deps, wts, win,
            _interior(jj, t - slope * jj, border, N, knight),
            dir2off=dir2off, mgm=mgm, use_fh=use_fh, **consts)
        vol[:, :, t] = new
        mins[:, :, t] = new_min
    return vol


def _k5_warp_smem(L: int) -> int:
    """Shared memory a warp of K5 takes for L labels: its ring of its
    row's last 8 columns (4 beyond 192 labels: csrc/wavefront.cu
    k5_ring), a value and its column's count in 8 bytes for each label
    and the minimum of each of its planes (two up to 48 labels), and its
    count."""
    return ((8 if L <= 192 else 4) * (2 if L <= 48 else 1) * (L + 1) * 8
            + 4)


def k5_plan(M: int, R: int, C: int, slope: int, L: int, sms: int,
            fits=None, G: int | None = None) -> K5Plan:
    """K5's launch plan for M planes of R rows and C columns at `slope`
    with L labels on a card of `sms` SMs: K5Plan(ctas, warps, smem), a
    pure function of its arguments.

    A warp holds a row, or for L <= 48 the same row of two planes (a
    plane group); the rows come in bands of `warps` rows of one plane
    group, band beta to CTA beta mod ctas (csrc/wavefront.cu).  A row
    starts about `slope` columns behind the row above, so about C /
    slope rows of a plane are busy at once: a plane group gets that many
    CTAs' worth of bands at most, plus K5_SLACK, and a CTA whose band is
    done takes its next one.  Every CTA must be resident at once (rows
    wait on rows of other CTAs): `fits(warps)` says how many CTAs of
    `warps` warps the card holds at once (the kernel's occupancy; None:
    `sms`, one CTA an SM), and a shape for which it holds none is
    refused.  `smem`: each warp's ring and count (_k5_warp_smem), as
    many warps as the CTA's shared memory holds.  G: K5 on a band, whose
    launch steps a block of G fronts: about (C + G) / slope rows of a
    plane have a column in it (None: K5, every front)."""
    if not (M >= 1 and R >= 1 and C >= 1 and slope >= 1
            and 1 <= L <= MAX_LABELS and sms >= 1 and (G is None or G >= 1)):
        raise ValueError(f"k5_plan: {M} planes of {R}x{C}, slope {slope}, "
                         f"L {L}, {sms} SMs")
    per_warp = _k5_warp_smem(L)
    groups = -(-M // (2 if L <= 48 else 1))
    warps = min(K5_WARPS, R, SMEM_PER_CTA // per_warp)
    bands = groups * -(-R // warps)
    busy = groups * (-(-(C + (G or 0)) // (slope * warps)) + K5_SLACK)
    held = sms if fits is None else fits(warps)
    if held < 1:
        raise ValueError(f"k5_plan: the card holds no CTA of {warps} warps "
                         f"for {M} planes of {R}x{C}, slope {slope}, L {L}")
    ctas = min(bands, busy, held)
    if -(-bands // ctas) * C >= 1 << 31:   # a CTA's counts: int32
        raise ValueError(f"k5_plan: {M} planes of {R}x{C} in {ctas} CTAs "
                         f"overflow the counts")
    return K5Plan(ctas=ctas, warps=warps, smem=warps * per_warp)


# K5's occupancy queries (mgm_k5_fit), by card, instance and CTA size
_FITS: dict = {}


def _check_maps(maps, wch, R, C, H, W, noffs) -> None:
    """Each pass's map must be a bijection of its R x C canonical pixels
    onto the H x W image (aggregate.pass_map's strides, every corner
    inside), with a weight channel for each offset rank."""
    if not 1 <= len(maps) <= MAX_PASSES or len(wch) != len(maps) or (
            H * W >= 1 << 31):
        raise ValueError(f"wavefront_scan: {len(maps)} pass maps, "
                         f"{len(wch)} weight tables, {H}x{W} pixels")
    for (o, dr, dc), ch in zip(maps, wch):
        corners = [o + i * (R - 1) * dr + j * (C - 1) * dc
                   for i in (0, 1) for j in (0, 1)]
        if ((R, C, abs(dr), abs(dc)) not in ((H, W, W, 1), (W, H, 1, W))
                or not all(0 <= x < H * W for x in corners)
                or len(ch) != noffs or not all(0 <= k < 8 for k in ch)):
            raise ValueError(f"wavefront_scan: pass map {(o, dr, dc)} "
                             f"(weight channels {ch}) is no orientation of "
                             f"{R}x{C} canonical pixels on a {H}x{W} image")


def _pixels(maps, R: int, C: int, device) -> torch.Tensor:
    """(B, R*C) int64: each pass's image pixel of canonical pixel (r, c)
    at r*C + c, through its map (origin, dr, dc)."""
    r = torch.arange(R, device=device)[:, None]
    c = torch.arange(C, device=device)[None, :]
    return torch.stack([(o + r * dr + c * dc).reshape(-1)
                        for o, dr, dc in maps])


def canonical_plain(x: torch.Tensor, pix: torch.Tensor, R: int,
                    C: int) -> torch.Tensor:
    """(N, H, W, k) image-layout values -> (B*N, R, C, k), pass-major:
    each pass's canonical orientation, gathered at its pixels `pix`
    (_pixels)."""
    N, k = x.shape[0], x.shape[-1]
    g = x.reshape(N, -1, k)[:, pix]            # (N, B, R*C, k)
    return g.transpose(0, 1).reshape(-1, R, C, k)


# the skew's fill of the canonical inputs: costs, weights, lo, hi (an
# empty window outside the image, aggregate.py:450-458 of the JAX module)
FILLS = (INF, 1.0, 0, -1)


def wavefront_scan_plain(cc, w8=None, lo=None, hi=None, *, R, C, maps, wch,
                         p1, p2, mgm, dir2off, slope, knight=False,
                         use_fh=False, use_weights=False, fh_restrict=False,
                         border=None):
    """Plain PyTorch version of K5: the TPU's pipeline written out.  Each
    pass's inputs gathered through its map into canonical orientation
    (what to_canonical gives), skewed (skew_plain), the front loop
    (_scan_fronts), unskewed (unskew_plain) and put back in image
    orientation through the map.  Arguments and result as in
    wavefront_scan."""
    N, H, W, L = cc.shape
    B = len(maps)
    _check_maps(maps, wch, R, C, H, W, len(set(dir2off)))
    pix = _pixels(maps, R, C, cc.device)
    w_c = lo_c = hi_c = None
    if use_weights:
        # offset rank outer, then pass, then image
        w8f = w8.reshape(N, H * W, 8)
        w_c = torch.stack([torch.stack([w8f[:, pix[b], ch[k]]
                                        for b, ch in enumerate(wch)])
                           for k in range(len(wch[0]))]).reshape(-1, R, C, 1)
    if fh_restrict:
        lo_c, hi_c = (canonical_plain(x.to(torch.int32)[..., None], pix, R, C)
                      for x in (lo, hi))
    vol, w_sk, lo_sk, hi_sk = (
        None if x is None else skew_plain(x, fill, slope)
        for x, fill in zip((canonical_plain(cc, pix, R, C), w_c, lo_c, hi_c),
                           FILLS))
    _scan_fronts(vol, w_sk, lo_sk, hi_sk, C=C, p1=p1, p2=p2, mgm=mgm,
                 dir2off=dir2off, slope=slope, knight=knight, use_fh=use_fh,
                 use_weights=use_weights, fh_restrict=fh_restrict,
                 border=border or full_border(B, C), N=N)
    lr = unskew_plain(vol, C, slope).reshape(B, N, R * C, L)
    out = torch.empty((B, N, H * W, L), dtype=cc.dtype, device=cc.device)
    for b in range(B):
        out[b][:, pix[b]] = lr[b]
    return out.reshape(B, N, H, W, L)


def _limits(name, *, mgm, dir2off, L, slope) -> tuple:
    """The offsets (ascending ids) of a launch within the kernel's
    limits; outside them raises."""
    offs = sorted(set(dir2off))
    if (len(dir2off) != mgm or not 1 <= mgm <= MAX_RANKS
            or not 1 <= L <= MAX_LABELS or slope not in OFF_LAG
            or any(o not in OFF_LAG[slope] for o in offs)):
        raise ValueError(f"{name}: outside the kernel's limits (mgm {mgm}, "
                         f"dir2off {dir2off}, L {L}, slope {slope})")
    return offs


def _scan_params(name, cc, w8, lo, hi, out, mins, *, R, C, maps, wch, p1,
                 p2, mgm, dir2off, slope, knight, use_fh, use_weights,
                 fh_restrict, border) -> _ScanParams:
    """K5's parameter block for CUDA tensors, every argument checked."""
    dev = cc.device
    if cc.ndim != 4:
        raise ValueError(f"{name}: want (N, H, W, L), got "
                         f"{tuple(cc.shape)}")
    N, H, W, L = cc.shape
    B = len(maps)
    M = B * N
    offs = _limits(name, mgm=mgm, dir2off=dir2off, L=L, slope=slope)
    _check_maps(maps, wch, R, C, H, W, len(offs))
    border = border or full_border(B, C)
    if len(border) != B or not all(0 <= r0 < R and 0 <= c0 and 1 <= c1
                                   and c0 + c1 <= C
                                   for r0, c0, c1 in border):
        raise ValueError(f"{name}: border {border} of {B} passes of "
                         f"{R}x{C}")
    _check("cc", cc, (N, H, W, L), (torch.float32,), dev)
    _check("out", out, (B, N, H, W, L), (torch.float32,), dev)
    _check("mins", mins, (M, R, C), (torch.float32,), dev)
    p = _ScanParams(cc=cc.data_ptr(), out=out.data_ptr(),
                    mins=mins.data_ptr(), B=B, N=N, H=H, W=W, M=M, R=R, C=C,
                    L=L, slope=slope, mgm=mgm, knight=int(knight),
                    use_fh=int(use_fh), use_weights=int(use_weights),
                    fh_restrict=int(fh_restrict), p1=p1, p2=p2,
                    noffs=len(offs))
    if use_weights:
        _check("w8", w8, (N, H, W, 8), (torch.float32,), dev)
        p.w8 = w8.data_ptr()
    if fh_restrict:
        _check("lo", lo, (N, H, W), (torch.int32,), dev)
        _check("hi", hi, (N, H, W), (torch.int32,), dev)
        p.lo, p.hi = lo.data_ptr(), hi.data_ptr()
    for k, off in enumerate(offs):
        p.off_lag[k], shift = OFF_LAG[slope][off]
        p.off_shift[k] = int(shift)
    for j, off in enumerate(dir2off):
        p.dir_rank[j] = offs.index(off)
    for b, ((o, dr, dc), ch, (r0, c0, c1)) in enumerate(zip(maps, wch,
                                                            border)):
        p.origin[b], p.dr[b], p.dc[b] = o, dr, dc
        p.row0[b], p.col0[b], p.c1[b] = r0, c0, c1
        for k, c in enumerate(ch):
            p.wch[b][k] = c
    return p


def _fits(entry: str, p: _ScanParams, inst: tuple, L: int):
    """The card's occupancy query of a K5 entry (`entry`: mgm_k5_fit or
    mgm_k5b_fit) for the instance of p: fits(warps), CTAs of that many
    warps the card holds at once."""
    def fits(warps):
        key = (entry,) + inst + (warps,)
        if key not in _FITS:
            _FITS[key] = getattr(_lib(), entry)(ctypes.byref(p), ctypes.byref(
                _K5Plan(1, warps, warps * _k5_warp_smem(L))))
        return _FITS[key]
    return fits


def wavefront_scan(cc, w8=None, lo=None, hi=None, *, R, C, maps, wch, p1, p2,
                   mgm, dir2off, slope, knight=False, use_fh=False,
                   use_weights=False, fh_restrict=False, border=None):
    """K5: the MGM recursion over one canonical pass group of B passes,
    read from and written to image layout.

    cc: (N, H, W, L) float32 costs.
    w8: (N, H, W, 8) float32 edge weights when use_weights.
    lo/hi: (N, H, W) int32 label windows when fh_restrict.
    R, C: the canonical rows and columns.  maps: each pass's (origin,
      dr, dc) (aggregate.pass_map): canonical pixel (r, c) of image n
      lies at image pixel n*H*W + origin + r*dr + c*dc.  wch: each
      pass's weight channel (w8's last axis) of each offset rank
      (offsets in ascending id order).  Plane m = b*N + n of the scan
      is pass b of image n.
    dir2off: canonical offset id per coupled dir (length mgm).
    border: each pass's (first real canonical row, first real column,
      real columns) when mesh padding rows lie in the image
      (aggregate._pad_geometry), else None (0, 0, C).
    Returns out (B, N, H, W, L) float32: each pass's aggregated volume
    in image orientation (border pixels hold their costs).
    CPU tensors take the plain version; CUDA tensors launch
    csrc/wavefront.cu once on the current stream, with k5_plan's sizes
    for the shape and the card; a launch the card refuses raises."""
    kw = dict(R=R, C=C, maps=maps, wch=wch, p1=p1, p2=p2, mgm=mgm,
              dir2off=dir2off, slope=slope, knight=knight, use_fh=use_fh,
              use_weights=use_weights, fh_restrict=fh_restrict,
              border=border)
    dev = cc.device
    if dev.type == "cpu":
        return wavefront_scan_plain(cc, w8, lo, hi, **kw)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_scan: unsupported device {dev}")
    N, H, W, L = cc.shape
    B = len(maps)
    M = B * N
    out = torch.empty((B, N, H, W, L), dtype=torch.float32, device=dev)
    mins = torch.empty((M, R, C), dtype=torch.float32, device=dev)
    p = _scan_params("wavefront_scan", cc, w8, lo, hi, out, mins, **kw)
    fits = _fits("mgm_k5_fit", p, (dev.index, bool(use_fh),
                                   bool(use_weights), L), L)
    with torch.cuda.device(dev):
        plan = k5_plan(M, R, C, slope, L, _sms(dev.index), fits)
        gdone, epoch = _gdone(dev, plan.ctas)
        err = _lib().mgm_wavefront_scan(
            ctypes.byref(p), ctypes.byref(_K5Plan(*plan)), gdone.data_ptr(),
            epoch, _stream(dev))
    if err == -1:
        raise RuntimeError(f"wavefront_scan: the card cannot hold the "
                           f"{plan.ctas} CTAs of {plan.warps} warps at once "
                           f"for {M} planes of {R}x{C}, slope {slope}, L "
                           f"{L}")
    if err:
        raise RuntimeError(f"wavefront_scan: CUDA error {err}")
    wavefront_scan.launches += 1
    return out


wavefront_scan.launches = 0


# ----------------------------------------------------------- K5 on a band ----

def _gather(x, pix, rows_cols):
    """(B*N, n, k) values of the (B or 1, N, H*W, k) image-layout tensor
    x at each pass's canonical pixels rows_cols (indices r*C + c, (n,)):
    pass b's through pix[b]; x's pass axis of 1 is every pass's."""
    B = pix.shape[0]
    return torch.stack([x[b if x.shape[0] > 1 else 0][:, pix[b][rows_cols]]
                        for b in range(B)]).flatten(0, 1)


def wavefront_band_plain(cc, w8, lo, hi, out, mins, halo=None, ship=None, *,
                         t0, G, r0, R, C, maps, wch, p1, p2, mgm, dir2off,
                         slope, knight=False, use_fh=False, use_weights=False,
                         fh_restrict=False, border=None):
    """Plain PyTorch version of K5 on a band (the port's counterpart of
    mgm_tpu/parallel/halo.py's _halo_scan): the fronts t0 .. t0 + G - 1
    of a pass group on the band's canonical rows, whose local row r is
    global canonical row r0 + r (front t holds its column t - slope*(r0
    + r)).  cc, w8, lo, hi: the band's image-layout inputs as K5 takes
    them, R x C canonical pixels through `maps`; out (B, N, H, W, L) and
    mins (M, R, C): the recursion so far (every earlier front of the
    band), updated in place; halo: (values (2G, M, L), minima (2G, M))
    of the row above the band (global row r0 - 1), its front s at entry
    s mod 2G, complete for the block's fronts and the 4 before them, or
    None (r0 == 0: no row above); ship: the same (G, M, L) and (G, M)
    tensors for the band's last row at the block's fronts, written
    where that row has a column, or None.  border: as wavefront_scan's,
    in global canonical rows."""
    N, H, W, L = cc.shape
    B = len(maps)
    M = B * N
    dev = cc.device
    _check_maps(maps, wch, R, C, H, W, len(set(dir2off)))
    border = border or full_border(B, C)
    pix = _pixels(maps, R, C, dev)
    consts = _consts(p1, p2, mgm, dev)
    lab = torch.arange(L, device=dev)
    ccf, outf = cc.reshape(1, N, H * W, L), out.reshape(B, N, H * W, L)
    w8f = w8.reshape(1, N, H * W, 8) if use_weights else None
    lof, hif = ((x.reshape(1, N, H * W, 1) for x in (lo, hi))
                if fh_restrict else (None, None))
    offs = sorted(set(dir2off))
    rr = torch.arange(R, device=dev)
    for t in range(t0, t0 + G):
        cols = t - slope * (r0 + rr)
        ok = (cols >= 0) & (cols < C)
        if not bool(ok.any()):
            continue
        rows, cols = rr[ok], cols[ok]
        idx = rows * C + cols

        def at(r, c):
            """Values and minima of the band's pixels (r, c) (rows r >= 0
            and columns in the image where `valid`), +inf elsewhere."""
            valid = (r >= 0) & (c >= 0) & (c < C)
            rc = (r.clamp(0, R - 1) * C + c.clamp(0, C - 1))
            f = _gather(outf, pix, rc)
            mk = mins.reshape(M, R * C)[:, rc]
            return (torch.where(valid[None, :, None], f, INF),
                    torch.where(valid[None], mk, INF))

        deps, wts = {}, {} if use_weights else None
        for rank, off in enumerate(offs):
            lag, shift = OFF_LAG[slope][off]
            if not shift:       # the row's own previous column
                f, mk = at(rows, cols - 1)
            else:               # the row above, column c + slope - lag
                c_up = cols + slope - lag
                f, mk = at(rows - 1, c_up)
                top = rows == 0
                if halo is not None and bool(top.any()):
                    # the band's first row reads the rank upstream's
                    # row at front t - lag
                    e = (t - lag) % (2 * G)
                    inside = top & (c_up >= 0) & (c_up < C)
                    f = torch.where(inside[None, :, None],
                                    halo[0][e][:, None], f)
                    mk = torch.where(inside[None], halo[1][e][:, None], mk)
            deps[off] = (f, mk)
            if use_weights:
                wts[off] = torch.stack([w8f[0][:, pix[b][idx], ch[rank]]
                                        for b, ch in enumerate(wch)]
                                       ).reshape(M, -1, 1)
        win = None
        if fh_restrict:
            win = ((lab >= _gather(lof, pix, idx))
                   & (lab <= _gather(hif, pix, idx)))
        new, new_min = _front_update(
            _gather(ccf, pix, idx), deps, wts, win,
            _interior(r0 + rows, cols, border, N, knight),
            dir2off=dir2off, mgm=mgm, use_fh=use_fh, **consts)
        for b in range(B):
            outf[b][:, pix[b][idx]] = new[b * N:(b + 1) * N]
        mins.reshape(M, R * C)[:, idx] = new_min
        if ship is not None and bool(rows[-1] == R - 1):
            ship[0][t - t0] = new[:, -1]
            ship[1][t - t0] = new_min[:, -1]
    return out


def bind_band(kernel, cc, w8, lo, hi, out, mins, *, halo=None, ship=None,
              r0, G, share=1, **kw):
    """`kernel` (K5 on a band, wavefront_band, or its plain version) with
    every argument but the block's first front bound, for a run of
    blocks on one band: returns step(t0), which runs the fronts t0 ..
    t0 + G - 1 (arguments as in wavefront_band_plain; G >= 4, the
    deepest lag; `share`: the ranks whose blocks run on the card at
    once, each planned on its share of the card).  K5 on a band on CUDA
    tensors builds its parameter block, plan and occupancy query once;
    anything else is called with the arguments as they are."""
    if kernel is wavefront_band and cc.device.type == "cuda":
        return _band_launcher(cc, w8, lo, hi, out, mins, halo=halo,
                              ship=ship, r0=r0, G=G, share=share, **kw)

    def step(t0: int) -> None:
        kernel(cc, w8, lo, hi, out, mins, halo, ship, t0=t0, G=G, r0=r0,
               **kw)

    return step


def _band_launcher(cc, w8, lo, hi, out, mins, *, halo, ship, r0, G, share,
                   **kw):
    """K5 on a band on CUDA tensors for a run of blocks: the parameter
    block, the plan (k5_plan on 1/share of the card, blocks of G fronts)
    and the occupancy query made once; returns step(t0), which launches
    csrc/wavefront_band.cu on the current stream of the tensors' card."""
    dev = cc.device
    N, H, W, L = cc.shape
    R, C, slope = kw["R"], kw["C"], kw["slope"]
    M = len(kw["maps"]) * N
    p = _scan_params("wavefront_band", cc, w8, lo, hi, out, mins, **kw)
    if G < 4 or r0 < 0 or (halo is None) != (r0 == 0):
        raise ValueError(f"wavefront_band: blocks of {G} fronts, band from "
                         f"row {r0}, halo {halo is not None}")
    for name, pair, steps in (("halo", halo, 2 * G), ("ship", ship, G)):
        if pair is not None:
            _check(name, pair[0], (steps, M, L), (torch.float32,), dev)
            _check(name + "_m", pair[1], (steps, M), (torch.float32,), dev)
            setattr(p, name, pair[0].data_ptr())
            setattr(p, name + "_m", pair[1].data_ptr())
    p.r0, p.G = r0, G
    T = C + slope * (r0 + R - 1)   # the band's last front + 1
    fits = _fits("mgm_k5b_fit", p, (dev.index, bool(kw["use_fh"]),
                                    bool(kw["use_weights"]), L), L)
    if not 1 <= share <= _sms(dev.index):
        raise ValueError(f"wavefront_band: {share} ranks on one card")
    with torch.cuda.device(dev):
        plan = k5_plan(M, R, C, slope, L, _sms(dev.index) // share,
                       lambda w: fits(w) // share, G=G)
    kplan = _K5Plan(*plan)
    lib = _lib()
    # the parameter block holds raw pointers: the tensors live as long
    # as the launcher
    tensors = (cc, w8, lo, hi, out, mins, halo, ship)

    def step(t0: int) -> None:
        if not 0 <= t0 < T:
            raise ValueError(f"wavefront_band: front {t0} of {T}")
        p.t0 = t0
        with torch.cuda.device(dev):
            gdone, epoch = _gdone(dev, plan.ctas)
            err = lib.mgm_wavefront_band(
                ctypes.byref(p), ctypes.byref(kplan), gdone.data_ptr(),
                epoch, _stream(dev))
        if err:
            why = ("the card cannot hold its CTAs at once" if err == -1
                   else f"CUDA error {err}")
            raise RuntimeError(f"wavefront_band: {why}: {plan} for {M} "
                               f"planes of {R}x{C} from row {r0}, slope "
                               f"{slope}, L {L}, fronts {t0} + {G}")
        wavefront_band.launches += 1

    step.tensors = tensors
    return step


def wavefront_band(cc, w8, lo, hi, out, mins, halo=None, ship=None, *, t0,
                   G, r0, share=1, **kw):
    """K5 on a band: the fronts t0 .. t0 + G - 1 (arguments as in
    wavefront_band_plain).  CPU tensors take the plain version; CUDA
    tensors launch csrc/wavefront_band.cu once on the current stream, the
    block's fronts stepped inside the kernel; a launch the card refuses
    raises.  A run of blocks on one band takes bind_band, which builds
    the launch once.  `launches` counts the blocks launched on the
    card."""
    dev = cc.device
    if dev.type == "cpu":
        return wavefront_band_plain(cc, w8, lo, hi, out, mins, halo, ship,
                                    t0=t0, G=G, r0=r0, **kw)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_band: unsupported device {dev}")
    _band_launcher(cc, w8, lo, hi, out, mins, halo=halo, ship=ship, r0=r0,
                   G=G, share=share, **kw)(t0)
    return out


wavefront_band.launches = 0
