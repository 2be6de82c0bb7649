"""K8, the pointwise cost volume (counterpart of mgm_tpu/ops/pallas_cost.py).

This module holds the kernel's ctypes binding, its wrapper, its plain
PyTorch version and a launch counter:

  K8 `pointwise_volume` (csrc/cost.cu) replaces pallas_cost._kernel:
     the raw (H, W, L) cost of every pixel and label for ad, sd, census
     (popcount of the XOR'd packed words x 1/nwords) and btad/btsd (from
     [I, Imin, Imax] channel blocks, which ops/cost.py builds first, as
     the JAX module does).  Label l reads the right image's column
     x + gmin + l clamped to the image, as the TPU's edge-padded slice.

The cost of one pixel pair is `pointwise_cost`, the plain version of
csrc/mgm_device.cuh's device function of that name; K1 computes the
same function in flight (ops/cuda_fused.py), so both kernels and both
plain versions share one definition each.

The volume comes out as (H, W, L), labels fastest, which
build_cost_volume and the dense solver read; the TPU's (L, W, H)
layout and the transposes around it are not carried over.

K8 is a fused elementwise pass, which Triton could write.  It is CUDA
C++ all the same: every kernel of the port lives in the one
nvcc-built library with one ctypes binding pattern, and its bitwise
equality with the plain version rests on that build's `--fmad=false`.

A wrapper runs the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises.  `launches`
counts kernel launches (never plain runs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .common import chsum, fmin3, pad_cols, shifted_cols

# the families of csrc/mgm_kernels.h (MGM_COST_*), in its order
MODES = ("ad", "sd", "census", "btad", "btsd")


class _CostParams(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("left", "right", "out")]
        + [(f, ctypes.c_int) for f in ("H", "W", "L", "nch", "gmin",
                                       "mode")]
        + [("inv_nw", ctypes.c_float)])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with K8's entry point typed and its parameter
    struct checked against the C layout."""
    lib = _build.load()
    lib.mgm_pointwise_volume.argtypes = [ctypes.POINTER(_CostParams),
                                         ctypes.c_void_p]
    lib.mgm_pointwise_volume.restype = ctypes.c_int
    lib.mgm_cost_params_size.restype = ctypes.c_int
    if lib.mgm_cost_params_size() != ctypes.sizeof(_CostParams):
        raise RuntimeError(f"mgm_pointwise_volume: C struct is "
                           f"{lib.mgm_cost_params_size()} bytes, the ctypes "
                           f"mirror {ctypes.sizeof(_CostParams)}")
    return lib


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


def pointwise_volume(u, v, *, gmin: int, L: int, mode: str):
    """K8: the raw (H, W, L) cost volume (arguments as in
    pointwise_volume_plain).  CPU tensors take the plain version; CUDA
    tensors launch csrc/cost.cu, one thread per (pixel, label)."""
    dev = u.device
    if mode == "census" and (u.dtype != torch.int32
                             or v.dtype != torch.int32):
        raise ValueError(f"pointwise_volume: census words must be int32, "
                         f"got {u.dtype} and {v.dtype}")
    if dev.type == "cpu":
        return pointwise_volume_plain(u, v, gmin=gmin, L=L, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"pointwise_volume: unsupported device {dev}")
    if mode not in MODES:
        raise ValueError(f"unknown distance {mode}")
    if u.ndim != 3 or u.shape != v.shape or v.device != dev:
        raise ValueError(f"pointwise_volume: want two (H, W, C) tensors of "
                         f"one shape on {dev}, got {tuple(u.shape)} on "
                         f"{u.device} and {tuple(v.shape)} on {v.device}")
    H, W, nch = u.shape
    if mode != "census" and (u.dtype != torch.float32
                             or v.dtype != torch.float32):
        raise ValueError(f"pointwise_volume: want float32 images, got "
                         f"{u.dtype} and {v.dtype}")
    if mode in ("btad", "btsd") and nch % 3:
        raise ValueError(f"pointwise_volume: BT needs [I, Imin, Imax] "
                         f"blocks, got {nch} channels")
    u, v = u.contiguous(), v.contiguous()
    out = torch.empty((H, W, L), dtype=torch.float32, device=dev)
    p = _CostParams(left=u.data_ptr(), right=v.data_ptr(),
                    out=out.data_ptr(), H=H, W=W, L=L, nch=nch, gmin=gmin,
                    mode=MODES.index(mode), inv_nw=1.0 / nch)
    err = _lib().mgm_pointwise_volume(ctypes.byref(p),
                                      torch.cuda.current_stream(
                                          dev).cuda_stream)
    if err:
        raise RuntimeError(f"pointwise_volume: CUDA error {err}")
    pointwise_volume.launches += 1
    return out


pointwise_volume.launches = 0
