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
    and each kernel's time beside its plain version's at cfg1 shapes;
 6. the dense path's kernels K6 (skew), K5 (wavefront scan) and K7
    (unskew) against their plain versions on a 64-row strip, 700 wide,
    L = 151, both LR problems: SGM TSGM 2 at slope 1 and 2, weighted FH
    at TSGM 2 and 3, knight passes (ndir 16, TSGM 4) and FH with
    per-pixel windows: bitwise equal;
 7. mgm_o at full width: a 700x500, L = 151 problem with a planted
    labelling (edge weights in {0.25, 1}) written in the mgm_o binary
    protocol, solved by mrf_cli.main (NDIR 8, P1 8, P2 32, MGM 2) for
    VTYPE 0 and 1 through K5/K6/K7 (launch counters), >= 95 % of the
    planted labels recovered, a crop equal to its CPU run, and the
    median wall time in MP*disp/s (H*W*L / s);
 8. the `ncc` preset at cfg1 geometry on the synthetic pair, LR both
    ways, through K5/K6/K7: >= 70 % of pixels survive the LR check and
    >= 95 % of those lie within 0.5 px of the true disparity; a crop
    equal to its CPU run; the median wall time in MP*disp/s;
 9. K6, K5 and K7 against their plain versions at the NCC run's
    largest pass group (the shapes the main path gives them): bitwise
    equal; then each one's time beside its plain version's and one
    PyTorch library call's.

With --data DIR holding fountain23-imL.png and fountain23-imR.png
(default: the repository's data/), cfg1 also runs on that pair.  The
last three lines are the per-kernel JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}; a failure exits
non-zero before them.  A kernel's `launches` counts its wrapper's
calls on the main paths, each path's counts zeroed just before its run
and read just after (`launches_by_path`): cfg1 (phase 4) for K1/K2,
the two mgm_o runs and the NCC run (phases 7-8) for K5/K6/K7;
`launches` is their sum.  One K1 or K5 call launches one small kernel
per wavefront.  `bound_ms` is the larger of the bytes the call must
move over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
H100 SXM's published peaks).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = "bitwise (equal NaN masks, equal bits elsewhere)"
# cfg1 (bench.py): 700x500x3, AD, disparities -120..30 (L = 151), 4
# directions, TSGM 2, P1 8, P2 32, LR both ways
H, W, DMIN, DMAX = 500, 700, -120, 30
L = DMAX - DMIN + 1
STRIP = 64                       # rows of the kernel-against-plain strip
CROP = (slice(100, 164), slice(200, 328))  # the CUDA-against-CPU crop
REPS = 5                         # timed cfg1 runs
DENSE_REPS = 3                   # timed mgm_o / NCC runs
HBM_BPS, F32_OPS = 3.35e12, 67e12  # H100 SXM peaks: bytes/s, FLOP/s
# phase 6: (what, ndir, mgm, FH, weights, per-pixel windows, pass group)
DENSE_CASES = (
    ("SGM TSGM 2, slope 1", 8, 2, False, False, False, 0),
    ("SGM TSGM 2, slope 2", 8, 2, False, False, False, 2),
    ("weighted FH TSGM 2", 8, 2, True, True, False, 0),
    ("weighted FH TSGM 3", 8, 3, True, True, False, 2),
    ("knight passes ndir 16 TSGM 4", 16, 4, False, False, False, 4),
    ("weighted FH TSGM 3, per-pixel windows", 8, 3, True, True, True, 0),
)
DENSE_KERNELS = ("wavefront_scan", "skew", "unskew")


def _device_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip()


def _compare(name, got, want):
    """Bitwise check of two float32 tensors on the device that holds
    `got`; returns max |got - want| over the entries both hold finite
    (0.0 when equal)."""
    import torch

    got, want = got.detach(), want.detach().to(got.device)
    ng, nw = torch.isnan(got), torch.isnan(want)
    if got.shape != want.shape or not torch.equal(ng, nw):
        raise AssertionError(f"{name}: shapes or NaN masks differ")
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = (float(torch.where(fin, got - want, 0.0).abs().max())
           if bool(fin.any()) else 0.0)
    same = (got.view(torch.int32) == want.view(torch.int32)) | ng
    if not bool(same.all()):
        raise AssertionError(f"{name}: differs from its plain version "
                             f"(max abs err {err})")
    return err


def _same_bits(name, got, want):
    """K6/K7 copy 32-bit words: every bit equal, NaN payloads too."""
    import torch

    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{name}: differs from its plain version")
    return 0.0


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


def _event_ms_fresh(prep, fn, reps: int, warm: bool = True):
    """(mean device time of fn(prep()) over `reps` runs, timing fn
    alone, and the last run's result), for a kernel that updates its
    input in place."""
    import torch

    if warm:
        fn(prep())
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total, out = 0.0, None
    for _ in range(reps):
        x = prep()
        del out
        torch.cuda.synchronize()
        start.record()
        out = fn(x)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
        del x
    return total / reps, out


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for a call moving `nbytes` and doing `ops`
    float32 operations."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _walls(fn, reps: int) -> list[float]:
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def _counts(wf):
    return {n: getattr(wf, n).launches for n in DENSE_KERNELS}


def _zero(wf):
    for n in DENSE_KERNELS:
        getattr(wf, n).launches = 0


def _dense_strip(case, rng, dev):
    """Phase 6, one case: K6, K5, K7 against their plain versions on the
    same inputs; returns max abs errors per kernel and the case's
    slope."""
    import torch
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf

    what, ndir, mgm, fh, wts, restrict, pick = case
    N = 2
    lo = np.zeros((N, STRIP, W), np.int32)
    hi = np.full((N, STRIP, W), L - 1, np.int32)
    if restrict:
        lo = rng.integers(0, L - 2, lo.shape).astype(np.int32)
        hi = (lo + rng.integers(1, L - 1, lo.shape)).clip(max=L - 1)
        hi = hi.astype(np.int32)
    cc = rng.uniform(0, 50, (N, STRIP, W, L)).astype(np.float32)
    inw = (np.arange(L) >= lo[..., None]) & (np.arange(L) <= hi[..., None])
    cc = np.where(inw, cc, np.inf).astype(np.float32)
    w8 = np.where(rng.random((N, STRIP, W, 8)) < 0.5, 0.25,
                  1.0).astype(np.float32)
    pids = agg._pass_groups(ndir, mgm)[pick]
    plan = agg.group_plan(pids, STRIP, W, mgm)
    canon = agg.canonical_inputs(
        plan, *(torch.from_numpy(a).to(dev) for a in (cc, w8, lo, hi)),
        use_weights=wts, fh_restrict=restrict)
    got = agg.skewed_inputs(canon, plan.slope)
    want = agg.skewed_inputs(canon, plan.slope, skew=wf.skew_plain)
    errs = {n: 0.0 for n in DENSE_KERNELS}
    for i, (g, w_) in enumerate(zip(got, want)):
        if w_ is not None:
            errs["skew"] = max(errs["skew"], _same_bits(f"K6 [{what}] {i}",
                                                        g, w_))
    kw = agg.scan_kwargs(plan, p1=8.0 * 3, p2=32.0 * 3, mgm=mgm, use_fh=fh,
                         use_weights=wts, fh_restrict=restrict)
    vol = wf.wavefront_scan(got[0].clone(), *got[1:], **kw)
    ref = wf.wavefront_scan_plain(got[0].clone(), *got[1:], **kw)
    torch.cuda.synchronize()
    errs["wavefront_scan"] = _compare(f"K5 [{what}]", vol, ref)
    errs["unskew"] = _same_bits(f"K7 [{what}]",
                                wf.unskew(vol, plan.C, plan.slope),
                                wf.unskew_plain(vol, plan.C, plan.slope))
    return errs, plan


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
    from mgm_tpu_torch import MGMConfig, compute_disparity, mrf_cli
    from mgm_tpu_torch.models import get_preset
    from mgm_tpu_torch.mrf import solve_mrf
    from mgm_tpu_torch.ops import _build, cuda_fused, fused
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf
    from mgm_tpu_torch.ops.cost import build_cost_volume
    from mgm_tpu_torch.synthetic import synthetic_mrf, synthetic_pair

    t_start = time.perf_counter()
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
        print(f"[2] K1 == plain at {STRIP}x{W}x3, L={L}, "
              f"ndir={ndir} TSGM={mgm} (slope {slope}): {TOL}, max abs err "
              f"{e1}")
        print(f"[3] K2 == plain on those planes: {TOL}, max abs err {e2}",
              flush=True)
        del got, want

    # ---- 4. cfg1 end to end -------------------------------------------
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
    walls = _walls(lambda: compute_disparity(u, v, cfg, device="cuda",
                                             outputs=("disp", "cost")), REPS)
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
    # K2's library yardstick: torch.min over the summed volume
    n_sides = len(sides)
    ssum = vol[:n_sides] + vol[n_sides:]
    library_ms = {"fused_wavefront": None,
                  "wta": _event_ms(lambda: torch.min(ssum, dim=-1), 10)}
    del ssum
    # K1 writes the volume forward and reads + writes it backward; K2
    # reads it once and writes disp and cost
    vbytes = vol.numel() * 4
    img_bytes = 2 * 2 * H * W * 3 * 4
    bounds = {"fused_wavefront": _bound(3 * vbytes + 2 * img_bytes,
                                        2 * vol.numel() * 30),
              "wta": _bound(vbytes + 2 * n_sides * H * W * 4,
                            2 * vol.numel())}
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

    # ---- 6. dense kernels against their plain versions ----------------
    rng = np.random.default_rng(6)
    for case in DENSE_CASES:
        e, plan = _dense_strip(case, rng, torch.device("cuda"))
        for n in DENSE_KERNELS:
            errs[n] = max(errs.get(n, 0.0), e[n])
        print(f"[6] K6, K5, K7 == plain at {STRIP}x{W}, L={L}, 2 problems, "
              f"{case[0]} (passes {plan.R}x{plan.C} canonical, slope "
              f"{plan.slope}): {TOL}, max abs err {e}", flush=True)
    torch.cuda.empty_cache()

    # ---- 7. mgm_o at full width ---------------------------------------
    unary, w8, planted = synthetic_mrf(H, W, L, seed=0)
    # per kernel: {main path: launches in that path's run}
    by_path = {n: {"cfg1": launches[n]} for n in launches}
    by_path.update({n: {} for n in DENSE_KERNELS})
    with tempfile.TemporaryDirectory() as tmp:
        f_in, f_out = os.path.join(tmp, "input.bin"), os.path.join(
            tmp, "labeling.bin")
        mrf_cli.write_problem(f_in, unary, w8)
        for vtype in (0, 1):
            argv = [f_in, f_out, "8", "32", "2", str(vtype)]
            _zero(wf)
            torch.cuda.reset_peak_memory_stats()
            if mrf_cli.main(argv) != 0:
                raise AssertionError(f"mrf_cli VTYPE {vtype} failed")
            got = _counts(wf)
            if min(got.values()) < 1:
                raise AssertionError(f"mgm_o VTYPE {vtype} bypassed a "
                                     f"kernel: {got}")
            for n in DENSE_KERNELS:
                by_path[n][f"mgm_o_vtype{vtype}"] = got[n]
            lab = np.fromfile(f_out, np.float32)
            if lab.shape != (H * W,) or not np.isfinite(lab).all():
                raise AssertionError(f"mgm_o labels: {lab.shape}")
            rec = float((lab.reshape(H, W) == planted).mean())
            peak = torch.cuda.max_memory_allocated() / 2**30
            mw = _walls(lambda: mrf_cli.main(argv), DENSE_REPS)
            mmed = statistics.median(mw)
            print(f"[7] mgm_o {W}x{H} L={L} NDIR 8 MGM 2 VTYPE {vtype} via "
                  f"mrf_cli.main: launches {got}, planted labels recovered "
                  f"{rec:.4f} (>= 0.95), peak device memory {peak:.3f} GiB;"
                  f" wall s {mw}, median {mmed:.4f} s = "
                  f"{H * W * L / mmed / 1e6:.1f} MP*disp/s on {card}",
                  flush=True)
            if rec < 0.95:
                raise AssertionError("mgm_o recovery below threshold")
            cu, cw = unary[:64, :96], w8[:64, :96]
            a = solve_mrf(cu, 8, 8.0, 32.0, 2, vtype, cw, device="cuda")
            b = solve_mrf(cu, 8, 8.0, 32.0, 2, vtype, cw, device="cpu")
            _compare(f"mgm_o crop VTYPE {vtype}", torch.from_numpy(a),
                     torch.from_numpy(b))
            print(f"[7] mgm_o on a {a.shape} crop, VTYPE {vtype}: CUDA == "
                  f"CPU plain ({TOL})", flush=True)
    del unary, w8

    # ---- 8. the ncc preset at cfg1 geometry ---------------------------
    ncc = get_preset("ncc", dmin=DMIN, dmax=DMAX)
    _zero(wf)
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, ncc, device="cuda")
    got = _counts(wf)
    if min(got.values()) < 1:
        raise AssertionError(f"NCC bypassed a kernel: {got}")
    for n in DENSE_KERNELS:
        by_path[n]["ncc"] = got[n]
    disp = out["disp"]
    if disp.shape != (H, W) or out["cost"].shape != (H, W):
        raise AssertionError(f"NCC output shapes {disp.shape}")
    ok = np.isfinite(disp)
    if not np.isfinite(out["cost"][ok]).all():
        raise AssertionError("NCC: a surviving pixel has no finite cost")
    survive = float(ok.mean())
    near = float((np.abs(disp[ok] - d_true[ok]) <= 0.5).mean())
    peak = torch.cuda.max_memory_allocated() / 2**30
    nw = _walls(lambda: compute_disparity(u, v, ncc, device="cuda",
                                          outputs=("disp", "cost")),
                DENSE_REPS)
    nmed = statistics.median(nw)
    print(f"[8] ncc preset {W}x{H}x3 L={L} (ndir 8, TSGM 2, window 5, "
          f"vfit, LR): launches {got}, LR survivors {survive:.4f} (>= 0.70),"
          f" within 0.5 px among them {near:.4f} (>= 0.95), peak device "
          f"memory {peak:.3f} GiB; wall s {nw}, median {nmed:.4f} s = "
          f"{2 * H * W * L / nmed / 1e6:.1f} MP*disp/s on {card}",
          flush=True)
    if survive < 0.70 or near < 0.95:
        raise AssertionError("NCC recovery below threshold")
    small_gpu = compute_disparity(u[CROP], v[CROP], ncc, device="cuda")
    small_cpu = compute_disparity(u[CROP], v[CROP], ncc, device="cpu")
    for k in small_cpu:
        _compare(f"NCC crop {k}", torch.from_numpy(small_gpu[k]),
                 torch.from_numpy(small_cpu[k]))
    print(f"[8] ncc on a {small_cpu['disp'].shape} crop: CUDA == CPU plain "
          f"for every output ({TOL})", flush=True)

    # ---- 9. dense kernel timing at the largest NCC pass group ---------
    dev = torch.device("cuda")
    ut, vt = (torch.from_numpy(a).to(dev).float() for a in (u, v))
    lo = torch.zeros((H, W), dtype=torch.int32, device=dev)
    hi = torch.full((H, W), L - 1, dtype=torch.int32, device=dev)
    cc = torch.stack([build_cost_volume(ut, vt, lo, hi, DMIN, distance="ncc",
                                        L=L, trunc_dist=ncc.trunc_dist,
                                        ncc_win=ncc.census_ncc_win),
                      build_cost_volume(vt, ut, lo, hi, -DMAX,
                                        distance="ncc", L=L,
                                        trunc_dist=ncc.trunc_dist,
                                        ncc_win=ncc.census_ncc_win)])
    groups = agg._pass_groups(ncc.ndir, ncc.mgm)
    plans = [agg.group_plan(g, H, W, ncc.mgm) for g in groups]
    big = max(range(len(plans)), key=lambda i: plans[i].R * (
        plans[i].C + plans[i].slope * (plans[i].R - 1)))
    plan = plans[big]
    x = agg.canonical_inputs(plan, cc, None, None, None, use_weights=False,
                             fh_restrict=False)[0]
    del cc
    s = plan.slope
    A, R, C, Lx = x.shape
    kw = agg.scan_kwargs(plan, p1=ncc.p1 * 3, p2=ncc.p2 * 3, mgm=ncc.mgm,
                         use_fh=False, use_weights=False, fh_restrict=False)
    inf = float("inf")
    # each kernel against its plain version on the same inputs, at the
    # shapes the NCC run gives it, then timed
    where = f"at the NCC run's largest group ({A}x{R}x{C}, L={Lx})"
    sk = wf.skew(x, inf, s)
    T = sk.shape[2]
    e9 = {"skew": _same_bits(f"K6 {where}", sk, wf.skew_plain(x, inf, s))}
    ms["skew"] = _event_ms(lambda: wf.skew(x, inf, s), 5)
    plain_ms["skew"] = _event_ms(lambda: wf.skew_plain(x, inf, s), 2)
    lib_out = torch.full_like(sk, inf)
    view = lib_out.as_strided((A, R, C, Lx), (R * T * Lx, (T + s) * Lx, Lx, 1))
    library_ms["skew"] = _event_ms(lambda: view.copy_(x), 5)
    if not torch.equal(lib_out, sk):
        raise AssertionError("K6's library yardstick computes another "
                             "function")
    del lib_out, view
    ms["wavefront_scan"], agg_sk = _event_ms_fresh(
        sk.clone, lambda y: wf.wavefront_scan(y, **kw), 3)
    plain_ms["wavefront_scan"], ref = _event_ms_fresh(
        sk.clone, lambda y: wf.wavefront_scan_plain(y, **kw), 1, warm=False)
    library_ms["wavefront_scan"] = None
    del sk
    e9["wavefront_scan"] = _compare(f"K5 {where}", agg_sk, ref)
    del ref
    e9["unskew"] = _same_bits(f"K7 {where}", wf.unskew(agg_sk, C, s),
                              wf.unskew_plain(agg_sk, C, s))
    ms["unskew"] = _event_ms(lambda: wf.unskew(agg_sk, C, s), 5)
    plain_ms["unskew"] = _event_ms(lambda: wf.unskew_plain(agg_sk, C, s), 2)
    lib_out = torch.empty_like(x)
    view = agg_sk.as_strided((A, R, C, Lx), (R * T * Lx, (T + s) * Lx, Lx, 1))
    library_ms["unskew"] = _event_ms(lambda: lib_out.copy_(view), 5)
    if not torch.equal(lib_out, wf.unskew(agg_sk, C, s)):
        raise AssertionError("K7's library yardstick computes another "
                             "function")
    del lib_out, view, agg_sk
    print(f"[9] K6, K5, K7 == plain {where}: {TOL}, max abs err {e9}",
          flush=True)
    for n in DENSE_KERNELS:
        errs[n] = max(errs[n], e9[n])
    xb, skb = x.numel() * 4, A * R * T * Lx * 4
    cells = A * R * C * Lx
    bounds["skew"] = _bound(xb + skb, 0)
    bounds["unskew"] = _bound(2 * xb, 0)
    # K5 touches only the real cells (0 <= t - slope*r < C): one read and
    # one write of them plus the minima it writes per cell; the skew's
    # fill is never read.  Per real cell: 2 messages of ~8 operations,
    # the halving sum, the add and the minimum
    bounds["wavefront_scan"] = _bound(2 * xb + A * R * C * 4, cells * 20)
    for n in DENSE_KERNELS:
        print(f"[9] {n}: {ms[n]:.3f} ms, plain {plain_ms[n]:.3f} ms, library "
              f"{library_ms[n]} ms, bound {bounds[n][0]:.3f} ms "
              f"({bounds[n][1]}) at the NCC run's largest group: {A} planes,"
              f" {R}x{C} canonical, slope {s}, {T} fronts, L={Lx} on {card}",
              flush=True)
    for n in DENSE_KERNELS:
        launches[n] = sum(by_path[n].values())
    print(f"[9] smoke run took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    src = {"fused_wavefront": ("mgm_tpu_torch/csrc/fused_wavefront.cu",
                               "mgm_tpu/ops/pallas_fused.py:692"),
           "wta": ("mgm_tpu_torch/csrc/wta.cu",
                   "mgm_tpu/ops/pallas_fused.py:158"),
           "wavefront_scan": ("mgm_tpu_torch/csrc/wavefront.cu",
                              "mgm_tpu/ops/pallas_wavefront.py:224"),
           "skew": ("mgm_tpu_torch/csrc/skew.cu",
                    "mgm_tpu/ops/pallas_wavefront.py:43"),
           "unskew": ("mgm_tpu_torch/csrc/skew.cu",
                      "mgm_tpu/ops/pallas_wavefront.py:93")}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1], "launches": launches[n],
         "launches_by_path": by_path[n], "max_abs_err": errs[n], "ms": ms[n], "plain_ms": plain_ms[n],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
         "library_ms": library_ms[n]}
        for n in src]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
