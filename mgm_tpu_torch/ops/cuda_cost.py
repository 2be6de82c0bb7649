"""K8, the dense cost volume (counterpart of mgm_tpu/ops/pallas_cost.py
and of the elementwise tail of mgm_tpu/ops/cost.build_cost_volume).

This module holds the kernel's ctypes binding, its wrapper, its plain
PyTorch version and a launch counter:

  K8 `cost_volume` (csrc/cost.cu) replaces pallas_cost._kernel and the
     tail that XLA fused onto it: the finished (H, W, L) volume of
     build_cost_volume for ad, sd, census (popcount of the XOR'd packed
     words x 1/nwords) and btad/btsd (from [I, Imin, Imax] channel
     blocks, which ops/cost.py builds first, as the JAX module does),
     in one pass.  Label l reads the right image's column x + gmin + l
     clamped to the image, as the TPU's edge-padded slice; a label off
     the image costs tmax, costs are truncated at tmax (NaN kept), a
     pixel whose window holds no finite cost is 0 there, and labels
     outside the window are +inf.  The kernel writes into a caller's
     slice of a stack of volumes (`out`).

The plain version is the composition the JAX module spells out:
`pointwise_volume_plain` (the raw costs) and `finish_volume` (the
tail, which the NCC volume also takes).  The cost of one pixel pair is
`pointwise_cost`, the plain version of csrc/mgm_device.cuh's pair_cost;
K1 computes the same terms in flight (ops/cuda_fused.py).

The volume comes out as (H, W, L), labels fastest, which the dense
solver reads; the TPU's (L, W, H) layout and the transposes around it
are not carried over.

K8 is a fused elementwise pass, which Triton could write.  It is CUDA
C++ all the same: every kernel of the port lives in the one
nvcc-built library with one ctypes binding pattern, and its bitwise
equality with the plain version rests on that build's `--fmad=false`.

A wrapper runs the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises.  `launches`
counts kernel launches (never plain runs).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
from .common import INF, chsum, fmin3, pad_cols, shifted_cols, window_mask
from .wavefront import SMEM_PER_CTA

# the families of csrc/mgm_kernels.h (MGM_COST_*), in its order
MODES = ("ad", "sd", "census", "btad", "btsd")
K8_OUT_WORDS = 10240    # K8 sizes a run's output span to about this many
K8_MAX_RUN = 64         # floats, 4 to 64 pixels (k8_plan)

K8Plan = collections.namedtuple("K8Plan", "tx smem")


class _CostParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("left", "right", "lo", "hi", "out")]
        + [(f, ctypes.c_int) for f in ("H", "W", "L", "nch", "gmin",
                                       "mode")]
        + [(f, ctypes.c_float) for f in ("inv_nw", "tmax")]
        + [(f, ctypes.c_int) for f in ("tx", "smem")])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with K8's entry point typed and its parameter
    struct checked against the C layout."""
    lib = _build.load()
    lib.mgm_cost_volume.argtypes = [ctypes.POINTER(_CostParams),
                                    ctypes.c_void_p]
    lib.mgm_cost_volume.restype = ctypes.c_int
    lib.mgm_cost_params_size.restype = ctypes.c_int
    if lib.mgm_cost_params_size() != ctypes.sizeof(_CostParams):
        raise RuntimeError(f"mgm_cost_volume: C struct is "
                           f"{lib.mgm_cost_params_size()} bytes, the ctypes "
                           f"mirror {ctypes.sizeof(_CostParams)}")
    return lib


def k8_plan(L: int, nch: int) -> K8Plan:
    """K8's launch plan: a CTA's run of `tx` pixels (a multiple of 4 from
    4 to K8_MAX_RUN, its output span about K8_OUT_WORDS floats) and its
    shared memory (csrc/cost.cu k8_words: the output span staged with 4
    words of room for its offset from a 16-byte boundary, the right
    columns the run reads, its left pixels and each pixel's lo and hi),
    a pure function of (L, nch).  tx is a multiple of the kernel's
    K8_PX = 4 pixels a warp."""
    if L < 1 or nch < 1:
        raise ValueError(f"k8_plan: L {L}, {nch} channels")
    tx = max(4, min(K8_MAX_RUN, K8_OUT_WORDS // L // 4 * 4))
    words = ((tx * L + 4 + 3) & ~3) + nch * (tx + L - 1) + tx * nch + 2 * tx
    if 4 * words > SMEM_PER_CTA:
        raise ValueError(f"k8_plan: L {L} x {nch} channels needs "
                         f"{4 * words} bytes of shared memory a CTA")
    return K8Plan(tx=tx, smem=4 * words)


def _popcount32(x):
    """Set bits of each int64 entry holding a value in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def pointwise_cost(u, v, mode: str):
    """The raw cost of each pixel pair, the plain version of
    mgm_device.cuh's pointwise_cost (K8 and K1 compute it on the card).

    u, v: broadcastable (..., Ck) channels-last tensors: float32 images
    (ad/sd), packed census words as int32, or BT's [I, Imin, Imax]
    blocks of C channels each (Ck = 3C).  Returns the (...) float32
    costs, channels summed left to right."""
    if mode == "census":
        inv_nw = torch.tensor(1.0 / u.shape[-1], dtype=torch.float32,
                              device=u.device)
        # int64 keeps the popcount arithmetic free of sign bits; & drops
        # the sign extension of the int32 words
        x = (u.to(torch.int64) ^ v.to(torch.int64)) & 0xFFFFFFFF
        return _popcount32(x).sum(-1).to(torch.float32) * inv_nw
    if mode in ("ad", "sd"):
        d = (u - v).abs()
        if mode == "sd":
            d = d * d
        return chsum(d)
    if mode in ("btad", "btsd"):
        C = u.shape[-1] // 3
        IL, umin, umax = u[..., :C], u[..., C:2 * C], u[..., 2 * C:]
        IR, vmin, vmax = v[..., :C], v[..., C:2 * C], v[..., 2 * C:]
        zero = torch.zeros((), dtype=torch.float32, device=u.device)
        dLR = -fmin3(zero, -(IL - vmax), -(vmin - IL))
        dRL = -fmin3(zero, -(IR - umax), -(umin - IR))
        bt = torch.minimum(dLR, dRL).abs()
        if mode == "btsd":
            bt = bt * bt
        return chsum(bt)
    raise ValueError(f"unknown distance {mode}")


def pointwise_volume_plain(u, v, *, gmin: int, L: int, mode: str):
    """Plain PyTorch version of K8 (pallas_cost.py:31-68): u, v are
    (H, W, Ck) images as pointwise_cost takes them; label l matches the
    right image's column x + gmin + l, clamped to the image.  Returns
    the (H, W, L) float32 raw costs."""
    W = v.shape[1]
    v_pad, left = pad_cols(v, gmin, L)
    return torch.stack([pointwise_cost(u, shifted_cols(v_pad, left, gmin,
                                                       l, W), mode)
                        for l in range(L)], -1)


def finish_volume(e, lo, hi, gmin: int, tmax: float, x0: int = 0,
                  width: int | None = None):
    """build_cost_volume's tail on the raw (H, W, L) costs `e`
    (mgm_costvolume.h:337-424): tmax where x + gmin + l lies off the
    image, the NaN-keeping minimum with tmax, 0 for every label of a
    pixel whose [lo, hi] window ((H, W) int32) holds no finite cost,
    +inf outside the window.  K8 does it in its one pass; the NCC volume
    takes it as tensor code.  x0, width: e's columns are the image's x0
    .. x0 + W - 1 of `width` (a band of columns; default the whole
    image)."""
    H, W, L = e.shape
    dev = e.device
    tmax = torch.tensor(tmax, dtype=torch.float32, device=dev)
    d = gmin + torch.arange(L, dtype=torch.int32, device=dev)
    qx = (torch.arange(x0, x0 + W, dtype=torch.int32, device=dev)[:, None]
          + d[None, :])
    valid_q = (qx >= 0) & (qx < (W if width is None else width))
    e = torch.where(valid_q[None], e, tmax)
    e = torch.minimum(e, tmax)
    in_win = window_mask(lo, hi, L)
    allinvalid = ~(in_win & torch.isfinite(e)).any(-1, keepdim=True)
    e = torch.where(allinvalid, 0.0, e)
    return torch.where(in_win, e, INF).to(torch.float32)


def cost_volume_plain(u, v, lo, hi, *, gmin: int, L: int, mode: str,
                      tmax: float):
    """Plain PyTorch version of K8: the raw costs (pointwise_volume_plain)
    finished by finish_volume.  u, v: (H, W, Ck) images as
    pointwise_cost takes them; lo, hi: (H, W) int32 label windows;
    tmax: the truncation.  Returns the (H, W, L) float32 volume."""
    return finish_volume(pointwise_volume_plain(u, v, gmin=gmin, L=L,
                                                mode=mode),
                         lo, hi, gmin, tmax)


def cost_volume(u, v, lo, hi, *, gmin: int, L: int, mode: str,
                tmax: float, out=None):
    """K8: the finished (H, W, L) cost volume (arguments as in
    cost_volume_plain), written into `out` (a contiguous (H, W, L)
    float32 tensor, e.g. a slice of a stack of volumes) when given.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/cost.cu, a CTA a run of k8_plan(L, Ck).tx pixels."""
    dev = u.device
    if mode not in MODES:
        raise ValueError(f"unknown distance {mode}")
    if mode == "census" and (u.dtype != torch.int32
                             or v.dtype != torch.int32):
        raise ValueError(f"cost_volume: census words must be int32, "
                         f"got {u.dtype} and {v.dtype}")
    if dev.type == "cpu":
        vol = cost_volume_plain(u, v, lo, hi, gmin=gmin, L=L, mode=mode,
                                tmax=tmax)
        return vol if out is None else out.copy_(vol)
    if dev.type != "cuda":
        raise ValueError(f"cost_volume: unsupported device {dev}")
    if u.ndim != 3 or u.shape != v.shape or v.device != dev:
        raise ValueError(f"cost_volume: want two (H, W, C) tensors of "
                         f"one shape on {dev}, got {tuple(u.shape)} on "
                         f"{u.device} and {tuple(v.shape)} on {v.device}")
    H, W, nch = u.shape
    if mode != "census" and (u.dtype != torch.float32
                             or v.dtype != torch.float32):
        raise ValueError(f"cost_volume: want float32 images, got "
                         f"{u.dtype} and {v.dtype}")
    if mode in ("btad", "btsd") and nch % 3:
        raise ValueError(f"cost_volume: BT needs [I, Imin, Imax] "
                         f"blocks, got {nch} channels")
    for name, t in (("lo", lo), ("hi", hi)):
        if (t.shape != (H, W) or t.dtype != torch.int32
                or t.device != dev):
            raise ValueError(f"cost_volume: want an ({H}, {W}) int32 {name} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if out is None:
        out = torch.empty((H, W, L), dtype=torch.float32, device=dev)
    elif (out.shape != (H, W, L) or out.dtype != torch.float32
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"cost_volume: want a contiguous ({H}, {W}, {L}) "
                         f"float32 out on {dev}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    plan = k8_plan(L, nch)
    u, v, lo, hi = (t.contiguous() for t in (u, v, lo, hi))
    p = _CostParams(left=u.data_ptr(), right=v.data_ptr(),
                    lo=lo.data_ptr(), hi=hi.data_ptr(), out=out.data_ptr(),
                    H=H, W=W, L=L, nch=nch, gmin=gmin,
                    mode=MODES.index(mode), inv_nw=1.0 / nch, tmax=tmax,
                    **plan._asdict())
    err = _lib().mgm_cost_volume(ctypes.byref(p),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cost_volume: CUDA error {err}")
    cost_volume.launches += 1
    return out


cost_volume.launches = 0
