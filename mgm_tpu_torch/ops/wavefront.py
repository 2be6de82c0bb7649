"""The dense path's three kernels (counterpart of
mgm_tpu/ops/pallas_wavefront.py).

For each kernel this module holds the ctypes binding, the wrapper, the
plain PyTorch version and a launch counter:

  K5 `wavefront_scan` (csrc/wavefront.cu) replaces
     pallas_wavefront._kernel: the MGM recursion over one skewed
     canonical pass group, SGM or FH, weighted or not, knight or not.
  K6 `skew` (csrc/skew.cu) replaces pallas_wavefront._skew_kernel:
     out[a, r, slope*r + c, b] = x[a, r, c, b], fill elsewhere.
  K7 `unskew` (csrc/skew.cu) replaces pallas_wavefront._unskew_kernel,
     the inverse of K6.

A wrapper runs the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises.  `launches`
counts the calls that launched the kernel (never plain runs); one K5
call launches one small kernel per wavefront.

The skewed volumes have T = C + slope*(R-1) fronts: the TPU's row
rounding (Rp), store margin and front blocking (t_round, G) are gone.
K5 updates its volume in place (the JAX kernel returns a new array):
the skewed volume is a temporary of the pass group, and the in-place
update saves a second copy of it, up to 3.2 GB at cfg1 geometry.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from . import _build
from .common import INF, fmin3, shift_fill

# the limits of csrc/mgm_kernels.h
MAX_LABELS, MAX_OFFS, MAX_RANKS = 1024, 5, 4

# per skew slope: canonical offset id -> (front lag, needs row shift).
# Slope 2 holds for every pass; slope 1 is valid whenever the NE offset
# (same-front on slope 1) is inactive — axis passes with mgm <= 3 and
# all knight passes — and shrinks the skewed volume by ~30%.
OFF_LAG = {
    2: {0: (1, False), 1: (2, True), 2: (3, True), 3: (1, True),
        4: (4, True)},
    1: {0: (1, False), 1: (1, True), 2: (2, True), 4: (3, True)},
}


class _ScanParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("vol", "mins", "w", "lo", "hi")]
        + [(f, ctypes.c_int) for f in ("M", "R", "T", "C", "L", "slope",
                                       "mgm", "knight", "use_fh",
                                       "use_weights", "fh_restrict")]
        + [(f, ctypes.c_float) for f in ("p1", "p2")]
        + [("noffs", ctypes.c_int),
           ("off_lag", ctypes.c_int * MAX_OFFS),
           ("off_shift", ctypes.c_int * MAX_OFFS),
           ("dir_rank", ctypes.c_int * MAX_RANKS)])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with this module's entry points typed."""
    lib = _build.load()
    lib.mgm_wavefront_scan.argtypes = [ctypes.POINTER(_ScanParams),
                                       ctypes.c_void_p]
    lib.mgm_wavefront_scan.restype = ctypes.c_int
    lib.mgm_scan_params_size.restype = ctypes.c_int
    if lib.mgm_scan_params_size() != ctypes.sizeof(_ScanParams):
        raise RuntimeError(f"mgm_wavefront_scan: C struct is "
                           f"{lib.mgm_scan_params_size()} bytes, the ctypes "
                           f"mirror {ctypes.sizeof(_ScanParams)}")
    lib.mgm_skew.argtypes = ([ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_longlong] + [ctypes.c_int] * 5
                             + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
    lib.mgm_skew.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, t, shape, dtypes, device) -> None:
    if (t.dtype not in dtypes or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name}: want a contiguous {shape} tensor of "
                         f"{[str(d) for d in dtypes]} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


# ------------------------------------------------------------ K6 / K7 ----

def skew_plain(x: torch.Tensor, fill, slope: int) -> torch.Tensor:
    """Plain PyTorch version of K6: (A, R, C, B) -> (A, R, T, B)."""
    A, R, C, B = x.shape
    T = C + slope * (R - 1)
    out = torch.full((A, R, T, B), fill, dtype=x.dtype, device=x.device)
    for r in range(R):
        out[:, r, slope * r:slope * r + C] = x[:, r]
    return out


def unskew_plain(y: torch.Tensor, C: int, slope: int) -> torch.Tensor:
    """Plain PyTorch version of K7: (A, R, T, B) -> (A, R, C, B)."""
    R = y.shape[1]
    return torch.stack([y[:, r, slope * r:slope * r + C] for r in range(R)],
                       1)


def _fill_bits(fill, dtype) -> int:
    """The 32-bit pattern of `fill` in `dtype`."""
    if dtype == torch.float32:
        return struct.unpack("<I", struct.pack("<f", float(fill)))[0]
    return int(fill) & 0xFFFFFFFF


def _copy(name, src, dst, *, R, C, T, B, slope, fill, inverse) -> None:
    err = _lib().mgm_skew(src.data_ptr(), dst.data_ptr(), src.shape[0], R,
                          C, T, B, slope, fill, int(inverse),
                          _stream(src.device))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def skew(x: torch.Tensor, fill, slope: int) -> torch.Tensor:
    """K6: out[a, r, slope*r + c, b] = x[a, r, c, b], `fill` elsewhere;
    (A, R, C, B) float32 or int32 -> (A, R, C + slope*(R-1), B).  CPU
    tensors take the plain version; CUDA tensors launch csrc/skew.cu."""
    dev = x.device
    if dev.type == "cpu":
        return skew_plain(x, fill, slope)
    if dev.type != "cuda":
        raise ValueError(f"skew: unsupported device {dev}")
    if x.ndim != 4:
        raise ValueError(f"skew: want (A, R, C, B), got {tuple(x.shape)}")
    A, R, C, B = x.shape
    _check("skew x", x, (A, R, C, B), (torch.float32, torch.int32), dev)
    T = C + slope * (R - 1)
    out = torch.empty((A, R, T, B), dtype=x.dtype, device=dev)
    _copy("skew", x, out, R=R, C=C, T=T, B=B, slope=slope,
          fill=_fill_bits(fill, x.dtype), inverse=False)
    skew.launches += 1
    return out


skew.launches = 0


def unskew(y: torch.Tensor, C: int, slope: int) -> torch.Tensor:
    """K7: the inverse of K6, (A, R, T, B) -> (A, R, C, B).  CPU tensors
    take the plain version; CUDA tensors launch csrc/skew.cu."""
    dev = y.device
    if dev.type == "cpu":
        return unskew_plain(y, C, slope)
    if dev.type != "cuda":
        raise ValueError(f"unskew: unsupported device {dev}")
    if y.ndim != 4:
        raise ValueError(f"unskew: want (A, R, T, B), got {tuple(y.shape)}")
    A, R, T, B = y.shape
    if T != C + slope * (R - 1):
        raise ValueError(f"unskew: {T} fronts, want C + slope*(R-1) = "
                         f"{C + slope * (R - 1)}")
    _check("unskew y", y, (A, R, T, B), (torch.float32, torch.int32), dev)
    out = torch.empty((A, R, C, B), dtype=y.dtype, device=dev)
    _copy("unskew", y, out, R=R, C=C, T=T, B=B, slope=slope, fill=0,
          inverse=True)
    unskew.launches += 1
    return out


unskew.launches = 0


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


def wavefront_scan_plain(vol, w_sk=None, lo_sk=None, hi_sk=None, *, C, p1,
                         p2, mgm, dir2off, slope, knight=False, use_fh=False,
                         use_weights=False, fh_restrict=False):
    """Plain PyTorch version of K5: a loop over fronts with tensor ops
    over (M, R, L), in _front_update's order of operations
    (pallas_wavefront.py:177-221).  Arguments as in wavefront_scan;
    updates `vol` in place and returns it."""
    M, R, T, L = vol.shape
    dev = vol.device
    f32 = dict(dtype=torch.float32, device=dev)
    offs = sorted(set(dir2off))
    p1f, p2f = torch.tensor(p1, **f32), torch.tensor(p2, **f32)
    # a true division (a 0-dim tensor on the device: CUDA would turn a
    # division by a Python number into a reciprocal multiply)
    mgm_div = torch.tensor(float(mgm), **f32)
    jj = torch.arange(R, device=dev)
    lab = torch.arange(L, device=dev)
    mins = torch.full((M, R, T), INF, **f32)
    none_f, none_m = (torch.full((M, R, L), INF, **f32),
                      torch.full((M, R), INF, **f32))
    for t in range(T):
        cc_t = vol[:, :, t]
        win = None
        if fh_restrict:
            win = ((lab >= lo_sk[:, :, t, 0, None])
                   & (lab <= hi_sk[:, :, t, 0, None]))
        msgs = {}
        for rank, off in enumerate(offs):
            lag, shift = OFF_LAG[slope][off]
            # fronts before the first are never read by an interior pixel
            f, mk = ((vol[:, :, t - lag], mins[:, :, t - lag]) if t >= lag
                     else (none_f, none_m))
            if shift:
                f, mk = shift_fill(f, 1, 1, INF), shift_fill(mk, 1, 1, INF)
            if use_weights:
                d = w_sk[rank * M:(rank + 1) * M, :, t]     # (M, R, 1)
                p1w, p2w = d * p1f, d * p2f
            else:
                p1w, p2w = p1f, p2f
            mk = mk[..., None]
            msgs[off] = (_fh_msg(f, mk, p1w, p2w, win) if use_fh
                         else _sgm_msg(f, mk, p1w, p2w))
        if mgm == 2 and not use_weights and not use_fh:
            # update_cost2 halves each term before summing (mgm_core.cc:83-84)
            e = msgs[dir2off[0]] * 0.5 + msgs[dir2off[1]] * 0.5
        else:
            e = msgs[dir2off[0]]
            for k in range(1, mgm):
                e = e + msgs[dir2off[k]]
            if mgm > 1:
                e = e / mgm_div
        ii = t - slope * jj
        if knight:
            # no +x offset; the main dir reaches 2 columns left
            interior = (jj >= 1) & (ii >= 2) & (ii <= C - 1)
        else:
            interior = (jj >= 1) & (ii >= 1) & (ii <= C - 2)
        # a select, never a multiply by the mask: border messages may
        # be inf - inf = NaN
        new = torch.where(interior[None, :, None], cc_t + e, cc_t)
        vol[:, :, t] = new
        mins[:, :, t] = new.amin(-1)
    return vol


def wavefront_scan(vol, w_sk=None, lo_sk=None, hi_sk=None, *, C, p1, p2,
                   mgm, dir2off, slope, knight=False, use_fh=False,
                   use_weights=False, fh_restrict=False):
    """K5: the MGM recursion over a skewed canonical pass group.

    vol: (M, R, T, L) float32 skewed costs, T = C + slope*(R-1); updated
      in place into the aggregated volume and returned.
    w_sk: (n_off*M, R, T, 1) float32 weights per offset rank (offsets in
      ascending id order) when use_weights.
    lo_sk/hi_sk: (M, R, T, 1) int32 label windows when fh_restrict.
    dir2off: canonical offset id per coupled dir (length mgm).
    CPU tensors take the plain version; CUDA tensors launch
    csrc/wavefront.cu, T front kernels on the current stream."""
    kw = dict(C=C, p1=p1, p2=p2, mgm=mgm, dir2off=dir2off, slope=slope,
              knight=knight, use_fh=use_fh, use_weights=use_weights,
              fh_restrict=fh_restrict)
    dev = vol.device
    if dev.type == "cpu":
        return wavefront_scan_plain(vol, w_sk, lo_sk, hi_sk, **kw)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_scan: unsupported device {dev}")
    if vol.ndim != 4:
        raise ValueError(f"wavefront_scan: want (M, R, T, L), got "
                         f"{tuple(vol.shape)}")
    M, R, T, L = vol.shape
    offs = sorted(set(dir2off))
    if (len(dir2off) != mgm or not 1 <= mgm <= MAX_RANKS
            or not 1 <= L <= MAX_LABELS or T != C + slope * (R - 1)
            or slope not in OFF_LAG
            or any(o not in OFF_LAG[slope] for o in offs)):
        raise ValueError(f"wavefront_scan: outside the kernel's limits "
                         f"(mgm {mgm}, dir2off {dir2off}, L {L}, slope "
                         f"{slope}, T {T} for C {C}, R {R})")
    _check("vol", vol, (M, R, T, L), (torch.float32,), dev)
    p = _ScanParams(vol=vol.data_ptr(), M=M, R=R, T=T, C=C, L=L,
                    slope=slope, mgm=mgm, knight=int(knight),
                    use_fh=int(use_fh), use_weights=int(use_weights),
                    fh_restrict=int(fh_restrict), p1=p1, p2=p2,
                    noffs=len(offs))
    mins = torch.empty((M, R, T), dtype=torch.float32, device=dev)
    p.mins = mins.data_ptr()
    if use_weights:
        _check("w_sk", w_sk, (len(offs) * M, R, T, 1), (torch.float32,), dev)
        p.w = w_sk.data_ptr()
    if fh_restrict:
        _check("lo_sk", lo_sk, (M, R, T, 1), (torch.int32,), dev)
        _check("hi_sk", hi_sk, (M, R, T, 1), (torch.int32,), dev)
        p.lo, p.hi = lo_sk.data_ptr(), hi_sk.data_ptr()
    for k, off in enumerate(offs):
        p.off_lag[k], shift = OFF_LAG[slope][off]
        p.off_shift[k] = int(shift)
    for j, off in enumerate(dir2off):
        p.dir_rank[j] = offs.index(off)
    err = _lib().mgm_wavefront_scan(ctypes.byref(p), _stream(dev))
    if err:
        raise RuntimeError(f"wavefront_scan: CUDA error {err}")
    wavefront_scan.launches += 1
    return vol


wavefront_scan.launches = 0
