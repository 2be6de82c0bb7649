#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mgm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--data DIR]

Run from a checkout: it builds the port's CUDA kernels from
mgm_tpu_torch/csrc (nvcc, sm_90a) and needs one CUDA card.  It imports
no JAX and nothing of mgm_tpu.  Phases, each fatal on failure:

 1. device: the card's name and power limit (nvidia-smi), the build;
 2. K1 (fused cost + MGM recursion) against its plain PyTorch version
    on the card, at cfg1 geometry on a 64-row strip (700 wide, L = 151,
    4 directions, TSGM 2, both LR sides, slope 1) and at slope 2 with
    front lag 3 (2 directions, TSGM 4): bitwise equal;
 3. K2 (space sum + windowed WTA) against its plain version on the
    same planes: bitwise equal;
 4. cfg1 end to end: compute_disparity(device="cuda") on a 700x500x3
    synthetic pair with a known disparity field (-120..30), through both
    kernels (launch counters), with the recovery thresholds checked, and
    the same pipeline on a crop equal to its CPU run;
 5. timing: the median of REPS cfg1 runs in MP*disp/s (2*H*W*L / s)
    and each kernel's time beside its plain version's at cfg1 shapes.

With --data DIR holding fountain23-imL.png and fountain23-imR.png
(default: the repository's data/), cfg1 also runs on that pair.  The
last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}; a failure exits non-zero before them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = "bitwise (equal NaN masks, equal bits elsewhere)"
# cfg1 (bench.py): 700x500x3, AD, disparities -120..30 (L = 151), 4
# directions, TSGM 2, P1 8, P2 32, LR both ways
H, W, DMIN, DMAX = 500, 700, -120, 30
STRIP = 64                       # rows of the kernel-against-plain strip
CROP = (slice(100, 164), slice(200, 328))  # the CUDA-against-CPU crop
REPS = 5                         # timed cfg1 runs


def _device_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip()


def _compare(name, got, want):
    """Bitwise check of two tensors; returns max |got - want| over the
    entries both hold finite (0.0 when equal)."""
    g, w = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    ng, nw = np.isnan(g), np.isnan(w)
    if g.shape != w.shape or not np.array_equal(ng, nw):
        raise AssertionError(f"{name}: shapes or NaN masks differ")
    fin = np.isfinite(g) & np.isfinite(w)
    err = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
    if not np.array_equal(g[~ng].view(np.uint32), w[~nw].view(np.uint32)):
        raise AssertionError(f"{name}: differs from its plain version "
                             f"(max abs err {err})")
    return err


def _planes(fn, u, v, *, ndir, mgm, dmin, dmax):
    """Both launches of one solve through `fn` (K1 or its plain version)
    on uint8 numpy images; returns (volume, sides, nspaces)."""
    import torch
    from mgm_tpu_torch.ops import fused

    L = dmax - dmin + 1
    sides = ((dmin, 0, L - 1), (-dmax, 0, L - 1))
    C = u.shape[-1]
    lefts = torch.from_numpy(np.stack([u, v])).cuda().float()
    rights = torch.from_numpy(np.stack([v, u])).cuda().float()
    vol, nspaces = fused.fused_planes(
        lefts, rights, sides=sides, L=L, ndir=ndir, mgm=mgm, p1=8.0 * C,
        p2=32.0 * C, mode="ad", tmax=float("inf"), kappa=-float(ndir - 1),
        wavefront=fn)
    return vol, sides, nspaces


def _event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=os.path.join(REPO, "data"),
                    help="directory with fountain23-im{L,R}.png (optional)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mgm_tpu_torch import MGMConfig, compute_disparity
    from mgm_tpu_torch.ops import _build, cuda_fused, fused
    from mgm_tpu_torch.synthetic import synthetic_pair

    # ---- 1. device and build ------------------------------------------
    card = _device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} visible",
          flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    print((lib.parent / "build.log").read_text().strip(), flush=True)

    # ---- 2./3. kernels against their plain versions ------------------
    errs = {"fused_wavefront": 0.0, "wta": 0.0}
    u, v, _ = synthetic_pair(STRIP, W, DMIN, DMAX, seed=1)
    for ndir, mgm in ((4, 2), (2, 4)):
        kw = dict(ndir=ndir, mgm=mgm, dmin=DMIN, dmax=DMAX)
        got, sides, ns = _planes(cuda_fused.fused_wavefront, u, v, **kw)
        want, _, _ = _planes(cuda_fused.fused_wavefront_plain, u, v, **kw)
        torch.cuda.synchronize()
        e1 = _compare(f"K1 ndir={ndir} mgm={mgm}", got, want)
        d1, c1 = cuda_fused.wta(got, nspaces=ns, sides=sides)
        d0, c0 = cuda_fused.wta_plain(got, nspaces=ns, sides=sides)
        torch.cuda.synchronize()
        e2 = max(_compare("K2 disp", d1, d0), _compare("K2 cost", c1, c0))
        errs["fused_wavefront"] = max(errs["fused_wavefront"], e1)
        errs["wta"] = max(errs["wta"], e2)
        slope = fused.split_passes(ndir, mgm)[0][0][0]
        print(f"[2] K1 == plain at {STRIP}x{W}x3, L={DMAX - DMIN + 1}, "
              f"ndir={ndir} TSGM={mgm} (slope {slope}): {TOL}, max abs err "
              f"{e1}")
        print(f"[3] K2 == plain on those planes: {TOL}, max abs err {e2}",
              flush=True)
        del got, want

    # ---- 4. cfg1 end to end -------------------------------------------
    L = DMAX - DMIN + 1
    cfg = MGMConfig(dmin=DMIN, dmax=DMAX, ndir=4, mgm=2, distance="ad",
                    p1=8, p2=32, test_lr=True)
    u, v, d_true = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    cuda_fused.fused_wavefront.launches = 0
    cuda_fused.wta.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, cfg, device="cuda")
    launches = {"fused_wavefront": cuda_fused.fused_wavefront.launches,
                "wta": cuda_fused.wta.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"cfg1 bypassed a kernel: {launches}")
    disp = out["disp"]
    if disp.shape != (H, W) or out["cost"].shape != (H, W):
        raise AssertionError(f"cfg1 output shapes {disp.shape}")
    ok = np.isfinite(disp)
    if not np.isfinite(out["cost"][ok]).all():
        raise AssertionError("cfg1: a surviving pixel has no finite cost")
    survive = float(ok.mean())
    correct = float((disp[ok] == d_true[ok]).mean())
    print(f"[4] cfg1 {W}x{H}x3 L={L}: launches {launches}, LR survivors "
          f"{survive:.4f} (>= 0.70), correct among them {correct:.4f} "
          f"(>= 0.95), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if survive < 0.70 or correct < 0.95:
        raise AssertionError("cfg1 recovery below threshold")
    small_gpu = compute_disparity(u[CROP], v[CROP], cfg, device="cuda")
    small_cpu = compute_disparity(u[CROP], v[CROP], cfg, device="cpu")
    for k in small_cpu:
        _compare(f"cfg1 crop {k}", torch.from_numpy(small_gpu[k]),
                 torch.from_numpy(small_cpu[k]))
    print(f"[4] cfg1 on a {small_cpu['disp'].shape} crop: CUDA == CPU plain "
          f"for every output ({TOL})", flush=True)

    # ---- 5. timing -----------------------------------------------------
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        compute_disparity(u, v, cfg, device="cuda", outputs=("disp", "cost"))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    med = statistics.median(walls)
    print(f"[5] cfg1 wall s per run: {walls}; median {med:.4f} s = "
          f"{2 * H * W * L / med / 1e6:.1f} MP*disp/s on {card}", flush=True)

    def k1(fn):
        return lambda: _planes(fn, u, v, ndir=4, mgm=2, dmin=DMIN,
                               dmax=DMAX)

    ms = {"fused_wavefront": _event_ms(k1(cuda_fused.fused_wavefront), 3)}
    vol, sides, ns = _planes(cuda_fused.fused_wavefront, u, v, ndir=4,
                             mgm=2, dmin=DMIN, dmax=DMAX)
    ms["wta"] = _event_ms(lambda: cuda_fused.wta(vol, nspaces=ns,
                                                 sides=sides), 10)
    plain_ms = {"wta": _event_ms(lambda: cuda_fused.wta_plain(
        vol, nspaces=ns, sides=sides), 3)}
    del vol
    plain_ms["fused_wavefront"] = _event_ms(
        k1(cuda_fused.fused_wavefront_plain), 1)
    for name in ms:
        print(f"[5] {name}: {ms[name]:.3f} ms, plain {plain_ms[name]:.3f} ms "
              f"(cfg1 shapes: 4 planes {H}x{W}, L={L}; K1 = forward + "
              f"backward launch) on {card}", flush=True)

    fl, fr = (os.path.join(args.data, f"fountain23-im{s}.png")
              for s in "LR")
    if os.path.exists(fl) and os.path.exists(fr):
        from mgm_tpu_torch.io import read_image

        fu, fv = (read_image(p).astype(np.uint8) for p in (fl, fr))
        compute_disparity(fu, fv, cfg, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = compute_disparity(fu, fv, cfg, device="cuda")
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        fh, fw = fu.shape[:2]
        print(f"[fountain23] {fw}x{fh}: {s:.4f} s = "
              f"{2 * fh * fw * L / s / 1e6:.1f} MP*disp/s, LR survivors "
              f"{np.isfinite(res['disp']).mean():.4f} on {card}")

    src = {"fused_wavefront": ("mgm_tpu_torch/csrc/fused_wavefront.cu",
                               "mgm_tpu/ops/pallas_fused.py:692"),
           "wta": ("mgm_tpu_torch/csrc/wta.cu",
                   "mgm_tpu/ops/pallas_fused.py:158")}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1], "launches": launches[n],
         "max_abs_err": errs[n], "ms": ms[n], "plain_ms": plain_ms[n]}
        for n in ("fused_wavefront", "wta")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
