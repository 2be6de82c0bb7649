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
 3. K2 (space sum + windowed WTA + the four subpixel taps) against its
    plain version on the same planes: bitwise equal;
 4. cfg1 end to end: compute_disparity(device="cuda") on a 700x500x3
    synthetic pair with a known disparity field (-120..30), through both
    kernels (launch counters), with the recovery thresholds checked, the
    same pipeline on a crop equal to its CPU run, peak device memory and
    the median of REPS runs in MP*disp/s (2*H*W*L / s); then the device
    kernel launches of K1 in one run, counted by torch.profiler: one a
    scan direction (2);
 5. K1 and K2 against their plain versions at cfg1's full shape (the
    synthetic pair, 700x500, L = 151, both LR sides): bitwise equal, K1
    in each of RACE_RUNS runs (a missing synchronisation shows as a
    race);
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
    PyTorch library call's;
10. K1 and K2 against their plain versions on a 64-row strip, 700
    wide, L = 151, both LR sides, for the V group (ndir 8, TSGM 2,
    slope 0) and the packed-parity group (ndir 8, TSGM 4, PA + PB):
    bitwise equal;
11. K8 (pointwise cost volume) against its plain version at 700x500,
    L = 151, for ad, sd, btad, btsd and census (random packed words):
    bitwise equal; then its time at full_16dir's two calls beside its
    plain version's;
12. full_16dir (bench_matrix's row: fast_ad at ndir 16, TSGM 2) end to
    end as phase 4, through K1 (A/B and V groups), K8 and K6/K5/K7 on
    the knight passes (launch counters);
13. cfg1_tsgm4 (fast_ad at TSGM 4: A and PB groups) end to end as
    phase 4, through K1 and K2;
14. K1 and K2 against their plain versions at the full shapes of
    full_16dir (A/B at slope 2 and V into one volume) and cfg1_tsgm4 (A
    at slope 2 and PB): bitwise equal; then K1's time per front of each
    group at full width: A/B at slope 2, V, PB, PA + PB, and cfg2's A/B
    and V groups (census, FH);
15. K1 and K2 (+ taps) against their plain versions at cfg2's full
    shape (census_tl over -120..30: 3x3 census words, FH, ndir 8,
    TSGM 3, A/B at slope 2 and V, both LR sides): bitwise equal, K1 in
    each of RACE_RUNS runs; then
    each one's time beside its plain version's, K2's beside torch.min,
    and their bounds: the kernels' record; then the same check at
    cfg4's full shape (sobelx_tl: AD on 3 float channels truncated at
    63*3, FH, ndir 8, TSGM 3);
16. K1 and K2 against their plain versions on a 64-row strip, 700 wide,
    L = 151: the `bt` preset (btad blocks, SGM, TSGM 2), cfg2 with
    edge weights (aP2 0.5) and fast_ad at ndir 8 with edge weights
    (SGM at TSGM 2, no update_cost2 halving): bitwise equal;
17. cfg2 (census_tl) and cfg4 (sobelx_tl: AD, FH, trunc_dist 63, vfit)
    end to end at 700x500x3, L = 151, as phase 4 with subpixel
    disparities: >= 0.70 LR survivors, >= 0.95 of them within 0.5 px
    (a surviving pixel's cost may be NaN only where the fit divides 0
    by 0, at most 1 %);
18. the `satellite`, `bt` and `full_16dir` presets on the crop: CUDA
    equal to CPU for every output;
19. K1 under per-pixel label windows (-m/-M) against its plain version
    on a 64-row strip, 700 wide, L = 151, both LR sides, windows the
    truth +- 6 clipped to the range with some one label wide and some
    empty: fast_ad at TSGM 2, census_tl (FH restricted to the target's
    window), FH at TSGM 2 unweighted (unrestricted) and weighted FH
    (restricted): bitwise equal;
20. cfg1_mM (bench_matrix's row: cfg1 with -m/-M images) end to end as
    phase 4, with the full-band constant images and with the truth +- 8:
    K1 only (the materialised S assembly, no K2); then K1's time per
    front at cfg1's full shape under per-pixel and constant windows,
    and K1 against its plain version at that shape under the truth +- 8
    windows: bitwise equal;
21. TSGM_ITER = 3 at cfg1 and with the ncc preset end to end as phase
    4 (the label axis widened by 16); TSGM_DEBUG on the crop: the
    energies of the CUDA and the CPU runs within 1e-6 relative;
22. cfg3_b8 and cfg3_b32: 8 and 32 synthetic satellite pairs (279x271x1,
    the `satellite` preset over -22..19, LR) through
    compute_disparity_batch: every pair's outputs bitwise equal to its
    own compute_disparity on the card, the launches one pair's, the
    median wall beside the sequential loop's; K1 and K2 (+ taps) against
    their plain versions on cfg3_b8's batch (K1's pair axis, K2's batch
    table): bitwise equal, K1 in each of RACE_RUNS runs; then K1's time
    per front at K = 8 against K = 1;
23. cfg3_scene: an 8x8 mosaic of one synthetic satellite pair
    (2232x2168) through runner.tiled_disparity(tile=512, margin=64,
    batch=5): 25 tiles, bitwise equal to batch=1, the median wall in
    MP*disp/s of scene work (2*H*W*L).

24. K4 (the fused recursion on one rank's band of rows, row sharding)
    against its plain version over in-process ranks on the one card,
    the whole sharded recursion held bitwise: the A/B stagger at cfg1's
    full 700x500, L = 151 over 2 ranks; cfg2's V group and
    cfg1_tsgm4's PB group (lockstep aprons) on 64-row strips over 2
    ranks; cfg1 on a 61-row strip over 3 ranks (21 + 21 + 19 rows);
    each also bitwise equal to K1's unsharded volume; then K4's time
    for a sharded cfg1 recursion beside its plain version's and its
    bound;
25. the sharded path end to end: compute_disparity(mesh=make_mesh(
    devices=["cuda:0"] * n)) for cfg1 at n = 2 and 4, and cfg2,
    cfg1_tsgm4 and cfg1_mM at n = 2, every output bitwise equal to the
    unsharded run's, through K4 and K2 (K1 not launched), the median
    wall of NEW_REPS runs beside the unsharded one's, in MP*disp/s,
    and peak memory (n ranks on one card run one after another: an
    emulation of n cards, not a multi-card measurement);
26. two processes on the one card (gloo; NCCL refuses two ranks on one
    GPU, and gloo takes CPU tensors, so the tracks go through host
    memory): cfg1 through parallel.distributed's
    compute_disparity_distributed, each process's outputs bitwise
    equal to the single-process run, and its wall;
27. with more than one card: the in-process mesh over distinct cards
    and the NCCL group (one line saying that they were not measured
    otherwise).

With --data DIR holding fountain23-imL.png and fountain23-imR.png
(default: the repository's data/), cfg1 also runs on that pair.  The
last three lines are the per-kernel JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}; a failure exits
non-zero before them.  A kernel's `launches` counts its wrapper's
calls on the main paths, each path's counts zeroed just before its run
and read just after (`launches_by_path`): cfg1 (phase 4), cfg1_tsgm4
(phase 13), cfg2 and cfg4 (phase 17), cfg1_iter3 (phase 21), cfg3_b8,
cfg3_b32 (phase 22) and cfg3_scene (phase 23) for K1/K2, cfg1_mM and
cfg1_mM_truth8 (phase 20) for K1, the two mgm_o runs, the NCC run
(phases 7-8) and ncc_iter3 (phase 21) for K5/K6/K7, full_16dir (phase
12) for K1, K5-K8, and the sharded rows (phase 25) for K4 and K2;
`launches` is their sum.  K4's times and bound are the sharded cfg1
recursion's over 2 ranks (phase 24).  One K1 call is one cluster launch
that steps every front of its scan direction inside the kernel; one K5
call launches one small kernel per wavefront.  K1's and K2's times and
bounds are cfg2's
(phase 15).  `bound_ms` is the larger of the bytes the call must move
over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the H100
SXM's published peaks).
"""
from __future__ import annotations

import argparse
import json
import math
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
FUSED_KERNELS = ("fused_wavefront", "wta")
CENSUS_WORDS = 2                 # phase 11's packed census words a pixel
NEW_REPS = 3                     # timed runs of phases 20-26
RACE_RUNS = 5                    # K1 runs held against one plain run
SHARD_KERNELS = ("fused_block", "wta")
# cfg3 (the satellite preset): 279x271x1 pairs, disparities -22..19
SAT_H, SAT_W, SAT_DMIN, SAT_DMAX = 271, 279, -22, 19


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


def _fast_ad(**kw):
    """bench_matrix's fast_ad rows: the preset over DMIN..DMAX, LR."""
    from mgm_tpu_torch.models import get_preset

    return get_preset("fast_ad", dmin=DMIN, dmax=DMAX, test_lr=True, **kw)


def _k1_inputs(cfg, u, v):
    """What compute_disparity(u, v, cfg, device="cuda") hands K1, made
    on the card from uint8 numpy images: each side's scrubbed and
    prefiltered images as K1 takes them (census: int32 words; BT:
    [I, Imin, Imax] blocks), the edge weights (None when all are 1)
    and the solve's arguments, as fused_planes' keywords."""
    from mgm_tpu_torch import stereo
    from mgm_tpu_torch.ops import fused

    C = u.shape[-1]
    L_ = cfg.dmax - cfg.dmin + 1
    u_t, v_t = (stereo._scrub(a, "cuda") for a in (u, v))
    w8 = stereo._weights((u_t, v_t), cfg)
    u_p, v_p = (stereo._preprocess(a, cfg) for a in (u_t, v_t))
    lefts, rights = fused.side_images(u_p[None], v_p[None], nsides=2,
                                      mode=cfg.distance)
    return dict(lefts=lefts, rights=rights, w8=w8, L=L_, mgm=cfg.mgm,
                sides=((cfg.dmin, 0, L_ - 1), (-cfg.dmax, 0, L_ - 1)),
                p1=cfg.p1 * C, p2=cfg.p2 * C, mode=cfg.distance,
                tmax=cfg.trunc_dist * u_p.shape[-1],
                use_fh=cfg.use_trunc_linear)


def _planes(fn, cfg, inp, group=None):
    """Every K1 launch of cfg's fused groups (or of group number `group`
    alone) through `fn` (K1 or its plain version) on _k1_inputs'
    `inp` (with lo_px/hi_px/fh_restrict and npair where it has them),
    with the solve's own overcount fold (none when it has leftover
    passes); returns (volume, nspaces)."""
    from mgm_tpu_torch.ops import fused

    groups, leftover = fused.split_passes(cfg.ndir, cfg.mgm)
    if group is not None:
        groups = groups[group:group + 1]
    kw = dict(inp)
    return fused.fused_planes(kw.pop("lefts"), kw.pop("rights"),
                              groups=groups, wavefront=fn,
                              kappa=0.0 if leftover else -float(cfg.ndir - 1),
                              **kw)


def _k1_bound(cfg, inp, nspaces):
    """(bound_ms, bound_by) of K1's launches of cfg at inp's shapes
    (_k1_work)."""
    return _bound(*_k1_work(cfg, inp, nspaces))


def _k1_work(cfg, inp, nspaces):
    """(bytes, float32 operations) of K1's launches of cfg at inp's
    shapes: the
    volume written forward and read and written backward, the images
    and weights read once; per cell of each fused pass the messages,
    their sum and division and the cost's add, and per cell of each
    plane the cost (3 operations a channel, truncation, window).  A
    message takes 6 operations a label, SGM and FH alike: the FH
    message is the L1 distance transform, a forward and a backward
    sweep of an add and a minimum, then the cap and the difference
    (K1's min-plus doubling does 2*ceil(log2 L) steps of 3 instead,
    more work than the function needs)."""
    from mgm_tpu_torch.ops import fused

    N, R, C, nch = inp["lefts"].shape
    L_, mgm = inp["L"], cfg.mgm
    cells = N * R * C * L_
    nbytes = 3 * nspaces * cells * 4 + 2 * inp["lefts"].numel() * 4
    for k in ("w8", "lo_px", "hi_px"):   # the per-pixel windows: int32
        if inp.get(k) is not None:
            nbytes += inp[k].numel() * 4
    npass = cfg.ndir - len(fused.split_passes(cfg.ndir, mgm)[1])
    ops = (npass * cells * (mgm * 6 + mgm + 1)
           + nspaces * cells * (3 * nch + 2))
    return nbytes, ops


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


def _event_once(fn):
    """(device time of one fn() run by CUDA events, its result)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


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


def _device_launches(fn, name: str) -> int:
    """The device kernels whose name holds `name` that one fn() run
    launches, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name)


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


def _kernels() -> dict:
    """Every kernel wrapper of the port by name (each has `launches`)."""
    from mgm_tpu_torch.ops import cuda_cost, cuda_fused
    from mgm_tpu_torch.ops import wavefront as wf

    return {"fused_wavefront": cuda_fused.fused_wavefront,
            "wta": cuda_fused.wta, "fused_block": cuda_fused.fused_block,
            "wavefront_scan": wf.wavefront_scan,
            "skew": wf.skew, "unskew": wf.unskew,
            "pointwise_volume": cuda_cost.pointwise_volume}


def _counts(names):
    k = _kernels()
    return {n: k[n].launches for n in names}


def _zero(names):
    for n in names:
        _kernels()[n].launches = 0


def _crop_check(phase, tag, cfg, u, v, win=None):
    """compute_disparity on CROP: every output of the CUDA run bitwise
    equal to the CPU run's (the plain versions of the kernels); `win`:
    the run's (H, W) -m/-M windows, cropped alike."""
    import torch
    from mgm_tpu_torch import compute_disparity

    kw = {k: a[CROP] for k, a in (win or {}).items()}
    small_gpu = compute_disparity(u[CROP], v[CROP], cfg, device="cuda", **kw)
    small_cpu = compute_disparity(u[CROP], v[CROP], cfg, device="cpu", **kw)
    for k in small_cpu:
        _compare(f"{tag} crop {k}", torch.from_numpy(small_gpu[k]),
                 torch.from_numpy(small_cpu[k]))
    print(f"[{phase}] {tag} on a {small_cpu['disp'].shape} crop: CUDA == "
          f"CPU plain for every output ({TOL})", flush=True)


def _stereo_path(phase, tag, cfg, pair, names, card, reps, tol=0.0,
                 win=None, absent=(), L_=None):
    """One stereo row end to end at full width: the kernels `names`
    counted over one compute_disparity(device="cuda") run (each must
    launch, each of `absent` must not), shapes, finite costs, the
    recovery thresholds (>= 0.70 LR survivors, >= 0.95 of them within
    `tol` px of the truth: 0 for the integer rows, 0.5 px for the
    refined ones), peak device memory, a crop equal to its CPU run, and
    the median wall of `reps` runs in MP*disp/s over L_ labels (default
    dmin..dmax).  `win`: -m/-M windows (dmin_img, dmax_img).  Returns
    the launch counts."""
    import torch
    from mgm_tpu_torch import compute_disparity

    u, v, d_true = pair
    H_, W_ = u.shape[:2]
    L_ = L_ or cfg.dmax - cfg.dmin + 1
    win = win or {}
    _zero(names + tuple(absent))
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, cfg, device="cuda", **win)
    got = _counts(names)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if min(got.values()) < 1 or any(_counts(absent).values()):
        raise AssertionError(f"{tag} bypassed a kernel or launched one "
                             f"off its path: {got}, {_counts(absent)}")
    disp = out["disp"]
    if disp.shape != (H_, W_) or out["cost"].shape != (H_, W_):
        raise AssertionError(f"{tag} output shapes {disp.shape}")
    ok = np.isfinite(disp)
    cost = out["cost"][ok]
    # a refined cost is NaN where the fit divides 0 by 0 (flat taps,
    # refine.h), and the median then fills that pixel's disparity
    nan_cost = float(np.isnan(cost).mean())
    if not (np.isfinite(cost) | np.isnan(cost)).all() or nan_cost > (
            0.01 if cfg.refinement != "none" else 0.0):
        raise AssertionError(f"{tag}: surviving pixels without a finite "
                             f"cost ({nan_cost} NaN)")
    survive = float(ok.mean())
    correct = float((np.abs(disp[ok] - d_true[ok]) <= tol).mean())
    print(f"[{phase}] {tag} {W_}x{H_}x3 L={L_} (ndir {cfg.ndir}, TSGM "
          f"{cfg.mgm}, {cfg.distance}, {'FH' if cfg.use_trunc_linear else 'SGM'}"
          f", refinement {cfg.refinement}): launches {got}, LR survivors "
          f"{survive:.4f} (>= 0.70), within {tol} px among them "
          f"{correct:.4f} (>= 0.95), NaN costs among them {nan_cost:.5f} "
          f"(degenerate fits, <= 0.01), peak device memory {peak:.3f} GiB",
          flush=True)
    if survive < 0.70 or correct < 0.95:
        raise AssertionError(f"{tag} recovery below threshold")
    _crop_check(phase, tag, cfg, u, v, win)
    walls = _walls(lambda: compute_disparity(u, v, cfg, device="cuda",
                                             outputs=("disp", "cost"), **win),
                   reps)
    med = statistics.median(walls)
    print(f"[{phase}] {tag} wall s per run: {walls}; median {med:.4f} s = "
          f"{2 * H_ * W_ * L_ / med / 1e6:.1f} MP*disp/s on {card}",
          flush=True)
    return got


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


def _fused_check(phase, cases, errs, u, v, runs=1):
    """K1 and K2 (with the subpixel taps) against their plain versions
    on the uint8 pair (u, v), both LR sides, for each (label, cfg,
    group) case (group None: every fused group of the solve), K1 in
    each of `runs` runs; folds the max abs errors into `errs` and
    returns each case's plain K1 time (ms, one run)."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused, fused

    plain_ms = []
    for label, cfg, group in cases:
        inp = _k1_inputs(cfg, u, v)
        if cfg.a_p2 != 1.0 and inp["w8"] is None:
            raise AssertionError(f"{label}: every edge weight is 1")
        got, ns = _planes(cuda_fused.fused_wavefront, cfg, inp, group)
        t, (want, _) = _event_once(lambda: _planes(
            cuda_fused.fused_wavefront_plain, cfg, inp, group))
        plain_ms.append(t)
        e1 = _compare(f"K1 {label} group={group}", got, want)
        for run in range(1, runs):
            again, _ = _planes(cuda_fused.fused_wavefront, cfg, inp, group)
            e1 = max(e1, _compare(f"K1 {label} group={group} run {run}",
                                  again, want))
            del again
        del want
        sides = inp["sides"]
        k2 = cuda_fused.wta(got, nspaces=ns, sides=sides, want_taps=True)
        ref = cuda_fused.wta_plain(got, nspaces=ns, sides=sides,
                                   want_taps=True)
        torch.cuda.synchronize()
        e2 = max(_compare(f"K2 {what} {label}", a, b)
                 for what, a, b in zip(("disp", "cost", "taps"), k2, ref))
        errs["fused_wavefront"] = max(errs["fused_wavefront"], e1)
        errs["wta"] = max(errs["wta"], e2)
        groups = fused.split_passes(cfg.ndir, cfg.mgm)[0]
        if group is not None:
            groups = groups[group:group + 1]
        what = ", ".join(f"slope {g[0]} {'+'.join(g[1])}" for g in groups)
        print(f"[{phase}] K1 == plain at {u.shape[0]}x{u.shape[1]}x3"
              f"{f' in each of {runs} runs' if runs > 1 else ''}, "
              f"L={inp['L']}, {label}: ndir {cfg.ndir} TSGM {cfg.mgm}, "
              f"{cfg.distance} ({inp['lefts'].shape[-1]} channels a pixel), "
              f"{'FH' if cfg.use_trunc_linear else 'SGM'}, weights "
              f"{'on' if inp['w8'] is not None else 'off'} ({what}): {TOL}, "
              f"max abs err {e1}, plain {t:.1f} ms; K2 + taps == plain on "
              f"those planes ({ns} spaces): max abs err {e2}", flush=True)
        del got, k2, ref
    return plain_ms


def _fused_timing(phase, tag, cfg, u, v, errs, card):
    """K1 and K2 (+ taps) of cfg at the full shape of (u, v): checked
    against their plain versions (_fused_check), then each one's time
    beside its plain version's, K2's beside torch.min over the summed
    volume, and their bounds.  Returns (ms, plain_ms, library_ms,
    bounds), each {kernel name: value}."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused

    plain_ms = {"fused_wavefront": _fused_check(phase, ((tag, cfg, None),),
                                                errs, u, v, RACE_RUNS)[0]}
    inp = _k1_inputs(cfg, u, v)
    ms = {"fused_wavefront": _event_ms(lambda: _planes(
        cuda_fused.fused_wavefront, cfg, inp), 3)}
    vol, ns = _planes(cuda_fused.fused_wavefront, cfg, inp)
    sides = inp["sides"]
    n_sides = len(sides)
    ms["wta"] = _event_ms(lambda: cuda_fused.wta(
        vol, nspaces=ns, sides=sides, want_taps=True), 10)
    plain_ms["wta"] = _event_ms(lambda: cuda_fused.wta_plain(
        vol, nspaces=ns, sides=sides, want_taps=True), 3)
    # K2's library yardstick: torch.min over the summed volume
    ssum = vol[:n_sides]
    for si in range(1, ns):
        ssum = ssum + vol[si * n_sides:(si + 1) * n_sides]
    library_ms = {"fused_wavefront": None,
                  "wta": _event_ms(lambda: torch.min(ssum, dim=-1), 10)}
    del ssum
    # K2 reads the volume once and writes disp, cost and the 4 taps
    bounds = {"fused_wavefront": _k1_bound(cfg, inp, ns),
              "wta": _bound(vol.numel() * 4 + 6 * n_sides * H * W * 4,
                            2 * vol.numel())}
    del vol
    for name in ms:
        print(f"[{phase}] {name}: {ms[name]:.3f} ms, plain "
              f"{plain_ms[name]:.3f} ms, library {library_ms[name]} ms, "
              f"bound {bounds[name][0]:.3f} ms ({bounds[name][1]}) at {tag}'s "
              f"shapes ({ns * n_sides} planes {H}x{W}, L={inp['L']}; K1 = "
              f"every fused group, forward + backward launch) on {card}",
              flush=True)
    return ms, plain_ms, library_ms, bounds


def _index_windows(d_true, cfg, rng):
    """(N=2, R, C) int32 per-pixel label windows of both LR sides for a
    K1 check: the true disparity +- 6 clipped to the range (the right
    side's truth is the negated left one's), some one label wide, some
    empty after truncation (hi = lo - 1)."""
    import torch

    L_ = cfg.dmax - cfg.dmin + 1
    los, his = [], []
    for d, g in ((d_true, cfg.dmin), (-d_true, -cfg.dmax)):
        lo = np.clip(d - 6 - g, 0, L_ - 1)
        hi = np.clip(d + 6 - g, 0, L_ - 1)
        one = rng.random(d.shape) < 0.05
        hi = np.where(one, lo, hi)
        empty = rng.random(d.shape) < 0.02
        hi = np.where(empty, lo - 1, hi)
        los.append(lo)
        his.append(hi)
    return (torch.from_numpy(np.stack(los).astype(np.int32)).cuda(),
            torch.from_numpy(np.stack(his).astype(np.int32)).cuda())


def _pp_check(phase, cases, errs, strip, rng):
    """K1 under per-pixel windows against its plain version, bitwise, on
    the strip (u, v, truth), both LR sides, for each (label, cfg) case
    with the fh_restrict rule of ops/fused.mgm_solve_fused."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused

    u, v, d = strip
    for label, cfg in cases:
        inp = _k1_inputs(cfg, u, v)
        lo, hi = _index_windows(d, cfg, rng)
        restrict = (cfg.use_trunc_linear
                    and not (cfg.mgm == 2 and inp["w8"] is None))
        inp.update(lo_px=lo, hi_px=hi, fh_restrict=restrict)
        got, _ = _planes(cuda_fused.fused_wavefront, cfg, inp)
        t, (want, _) = _event_once(lambda: _planes(
            cuda_fused.fused_wavefront_plain, cfg, inp))
        e1 = _compare(f"K1 per-pixel {label}", got, want)
        errs["fused_wavefront"] = max(errs["fused_wavefront"], e1)
        print(f"[{phase}] K1 == plain under per-pixel windows at "
              f"{u.shape[0]}x{u.shape[1]}x3, L={inp['L']}, {label}: ndir "
              f"{cfg.ndir} TSGM {cfg.mgm}, {cfg.distance}, "
              f"{'FH' if cfg.use_trunc_linear else 'SGM'}, weights "
              f"{'on' if inp['w8'] is not None else 'off'}, fh_restrict "
              f"{restrict} (windows truth +- 6, "
              f"{float((hi - lo == 0).float().mean()):.3f} one label, "
              f"{float((hi < lo).float().mean()):.3f} empty): {TOL}, max abs "
              f"err {e1}, plain {t:.1f} ms", flush=True)
        del got, want


def _satellite_pairs(K, seed0=0):
    """K synthetic pairs at the satellite geometry (279x271, one
    channel, disparities -22..19), each from its own seed:
    (us, vs, truths), stacked."""
    from mgm_tpu_torch.synthetic import synthetic_pair

    ps = [synthetic_pair(SAT_H, SAT_W, SAT_DMIN, SAT_DMAX, seed=seed0 + k)
          for k in range(K)]
    return (np.stack([p[0][..., :1] for p in ps]),
            np.stack([p[1][..., :1] for p in ps]),
            np.stack([p[2] for p in ps]))


def _batch_k1_inputs(cfg, us, vs, K):
    """What compute_disparity_batch(us[:K], vs[:K], cfg) hands K1 and K2
    (constant windows, LR): the stacked side images and fused_planes'
    keywords (the pair axis, npair = K)."""
    import torch
    from mgm_tpu_torch import stereo
    from mgm_tpu_torch.ops import fused

    u_t, v_t = (stereo._scrub(a[:K], "cuda") for a in (us, vs))
    w8 = stereo._weights([img for k in range(K) for img in (u_t[k], v_t[k])],
                         cfg)
    ups, vps = (torch.stack([stereo._preprocess(a, cfg) for a in t])
                for t in (u_t, v_t))
    lefts, rights = fused.side_images(ups, vps, nsides=2, mode=cfg.distance)
    L_ = cfg.dmax - cfg.dmin + 1
    groups, leftover = fused.split_passes(cfg.ndir, cfg.mgm)
    C = us.shape[-1]
    kw = dict(sides=((cfg.dmin, 0, L_ - 1), (-cfg.dmax, 0, L_ - 1)), L=L_,
              groups=groups, mgm=cfg.mgm, p1=cfg.p1 * C, p2=cfg.p2 * C,
              mode=cfg.distance, tmax=cfg.trunc_dist * ups.shape[-1],
              kappa=0.0 if leftover else -float(cfg.ndir - 1),
              use_fh=cfg.use_trunc_linear, w8=w8, npair=K)
    return lefts, rights, kw


def _fronts(groups, R, C):
    """Fronts of one K1 pass over the groups at R x C."""
    from mgm_tpu_torch.ops import fused

    n = 0
    for gslope, _, launches in groups:
        slope, fstep = (1, 2) if gslope == fused.P_SLOPE else (gslope, 1)
        n += len(launches) * (fstep * (C - 1) + slope * (R - 1) + 1)
    return n


def _k4_planes(fn, cfg, inp, n, group=None):
    """The sharded recursion of cfg's fused groups (or group number
    `group` alone) over n in-process ranks on the card through `fn`
    (K4 or its plain version), with _k1_inputs' `inp`: ({rank: (r0,
    volume)}, nspaces)."""
    from mgm_tpu_torch.ops import fused
    from mgm_tpu_torch.parallel import make_mesh, sharded_fused_planes

    groups = fused.split_passes(cfg.ndir, cfg.mgm)[0]
    if group is not None:
        groups = groups[group:group + 1]
    kw = dict(inp)
    return sharded_fused_planes(kw.pop("lefts"), kw.pop("rights"),
                                mesh=make_mesh(devices=["cuda:0"] * n),
                                groups=groups, kernel=fn,
                                kappa=-float(cfg.ndir - 1), **kw)


def _k4_check(phase, cases, errs):
    """K4 against its plain version, the whole sharded recursion, and
    against K1's unsharded volume, bitwise, for each (label, cfg, pair,
    ranks, group) case; returns each case's plain time (ms, one run)."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused

    plain_ms = []
    for label, cfg, (u, v), n, group in cases:
        inp = _k1_inputs(cfg, u, v)
        got, ns = _k4_planes(cuda_fused.fused_block, cfg, inp, n, group)
        t, (want, _) = _event_once(lambda: _k4_planes(
            cuda_fused.fused_block_plain, cfg, inp, n, group))
        plain_ms.append(t)
        ref, _ = _planes(cuda_fused.fused_wavefront, cfg, inp, group)
        err, rows = 0.0, []
        for k in sorted(got):
            r0, vol = got[k]
            err = max(err, _compare(f"K4 {label} rank {k}", vol, want[k][1]))
            _compare(f"K4 {label} rank {k} against K1",
                     vol, ref[:, r0:r0 + vol.shape[1]])
            rows.append(vol.shape[1])
        errs["fused_block"] = max(errs["fused_block"], err)
        print(f"[{phase}] K4 == plain, sharded over {n} ranks of the card "
              f"(rows {rows}), {label}: {u.shape[0]}x{u.shape[1]}x3, "
              f"L={inp['L']}, ndir {cfg.ndir} TSGM {cfg.mgm}, "
              f"{cfg.distance}, {'FH' if cfg.use_trunc_linear else 'SGM'}, "
              f"{ns} spaces: {TOL}, max abs err {err}; every band == K1's "
              f"unsharded volume; plain {t:.1f} ms", flush=True)
        del got, want, ref, inp
        torch.cuda.empty_cache()
    return plain_ms


def _k4_bound(cfg, inp, n):
    """K1's bound (the same volume, images and operations) plus K4's
    tracks: each step's edge row shipped by n - 1 ranks and read by
    their neighbours, in every A/B sub-launch."""
    from mgm_tpu_torch.ops import fused
    from mgm_tpu_torch.parallel.fused_shard import _sub_launch

    nbytes, ops = _k1_work(cfg, inp, 2)
    _, R, C, _ = inp["lefts"].shape
    ns = len(inp["sides"])
    track = 0
    for g in fused.split_passes(cfg.ndir, cfg.mgm)[0]:
        if g[0] <= 0:
            continue
        for kw in fused.group_launches(g, inp["sides"], R=R, mgm=cfg.mgm,
                                       kappa=0.0, fold=False):
            T = kw["fstep"] * (C - 1) + kw["slope"] * (R - 1) + 1
            for space in range(len(kw["planes"]) // ns):
                ms = _sub_launch(kw, space, ns)[1]
                if ms is not None:
                    track += 2 * (n - 1) * T * len(ms) * inp["L"] * 4
    return _bound(nbytes + track, ops)


def _mesh_path(phase, tag, cfg, pair, n, card, win=None):
    """compute_disparity over n in-process ranks on the card: every
    output bitwise equal to the unsharded run's, K4 and (constant
    windows) K2 launched, K1 not; the median walls of NEW_REPS runs,
    sharded and unsharded.  Returns the launch counts."""
    import torch
    from mgm_tpu_torch import compute_disparity
    from mgm_tpu_torch.parallel import make_mesh

    u, v, _ = pair
    win = win or {}
    mesh = make_mesh(devices=["cuda:0"] * n)
    ref = compute_disparity(u, v, cfg, device="cuda", **win)
    names = ("fused_block",) if win else SHARD_KERNELS
    _zero(SHARD_KERNELS + ("fused_wavefront",))
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, cfg, mesh=mesh, **win)
    got = _counts(names)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if min(got.values()) < 1 or _counts(("fused_wavefront",))[
            "fused_wavefront"]:
        raise AssertionError(f"{tag}: the sharded run bypassed K4 or "
                             f"launched K1: {got}")
    if sorted(out) != sorted(ref):
        raise AssertionError(f"{tag}: keys {sorted(out)}")
    for k in ref:
        _compare(f"{tag} {k} against the unsharded run",
                 torch.from_numpy(out[k]), torch.from_numpy(ref[k]))
    walls = _walls(lambda: compute_disparity(
        u, v, cfg, mesh=mesh, outputs=("disp", "cost"), **win), NEW_REPS)
    walls1 = _walls(lambda: compute_disparity(
        u, v, cfg, device="cuda", outputs=("disp", "cost"), **win),
        NEW_REPS)
    H_, W_ = u.shape[:2]
    L_ = cfg.dmax - cfg.dmin + 1
    med, med1 = statistics.median(walls), statistics.median(walls1)
    print(f"[{phase}] {tag}: {W_}x{H_}x3 L={L_} over {n} ranks of one card "
          f"(ndir {cfg.ndir}, TSGM {cfg.mgm}, {cfg.distance}"
          f"{', per-pixel windows' if win else ''}): every output == the "
          f"unsharded run ({TOL}); launches {got}; peak device memory "
          f"{peak:.3f} GiB; wall s {walls}, median {med:.4f} s = "
          f"{2 * H_ * W_ * L_ / med / 1e6:.1f} MP*disp/s; unsharded "
          f"median {med1:.4f} s = {2 * H_ * W_ * L_ / med1 / 1e6:.1f} "
          f"MP*disp/s on {card}", flush=True)
    return got


def _dist_worker(pid: int, nprocs: int, port: str, outdir: str) -> int:
    """One process of phase 26/27's group: cfg1 through
    compute_disparity_distributed on the synthetic pair; writes its
    outputs and a line of launches and walls."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    from mgm_tpu_torch.ops import cuda_fused
    from mgm_tpu_torch.parallel import distributed
    from mgm_tpu_torch.synthetic import synthetic_pair

    distributed.initialize(f"localhost:{port}", nprocs, pid)
    try:
        u, v, _ = synthetic_pair(H, W, DMIN, DMAX, seed=0)
        cfg = _fast_ad()
        cuda_fused.fused_block.launches = 0
        out = distributed.compute_disparity_distributed(u, v, cfg)
        launches = cuda_fused.fused_block.launches
        np.savez(os.path.join(outdir, f"proc{pid}.npz"), **out)
        walls = []
        for _ in range(NEW_REPS):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            distributed.compute_disparity_distributed(
                u, v, cfg, outputs=("disp", "cost"))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        print(json.dumps({"pid": pid, "backend": dist.get_backend(),
                          "launches": launches, "walls": walls}),
              flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _two_processes(phase, tag, ref, card):
    """Phase 26/27: two processes of cfg1 over this card (or cards),
    each one's outputs bitwise equal to `ref`; returns (the launches of
    K4 in process 0's first run, its median wall, the backend)."""
    import socket

    import torch

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(pid), str(port), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        recs = []
        for pid, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"{tag} process {pid} failed:\n"
                                     f"{o[-4000:]}")
            recs.append(json.loads([ln for ln in o.splitlines()
                                    if ln.startswith('{"pid"')][-1]))
            got = np.load(os.path.join(tmp, f"proc{pid}.npz"))
            if sorted(got.files) != sorted(ref):
                raise AssertionError(f"{tag}: keys {sorted(got.files)}")
            for k in ref:
                _compare(f"{tag} process {pid} {k} against one process",
                         torch.from_numpy(got[k]), torch.from_numpy(ref[k]))
    med = statistics.median(recs[0]["walls"])
    print(f"[{phase}] {tag}: cfg1 {W}x{H}x3 L={L} over 2 processes "
          f"({recs[0]['backend']}): every output of each process == the "
          f"single-process run ({TOL}); K4 launches a process "
          f"{[r['launches'] for r in recs]}; process 0 wall s "
          f"{recs[0]['walls']}, median {med:.4f} s = "
          f"{2 * H * W * L / med / 1e6:.1f} MP*disp/s on {card}",
          flush=True)
    return recs[0]["launches"], med, recs[0]["backend"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist-worker"]:
        return _dist_worker(int(argv[1]), 2, argv[2], argv[3])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=os.path.join(REPO, "data"),
                    help="directory with fountain23-im{L,R}.png (optional)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mgm_tpu_torch import compute_disparity, mrf_cli, stereo
    from mgm_tpu_torch.models import get_preset
    from mgm_tpu_torch.runner import tiled_disparity
    from mgm_tpu_torch.stereo import compute_disparity_batch
    from mgm_tpu_torch.mrf import solve_mrf
    from mgm_tpu_torch.ops import _build, cuda_cost, cuda_fused, fused
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf
    from mgm_tpu_torch.ops.cost import _bt_aux, build_cost_volume
    from mgm_tpu_torch.parallel.fused_shard import BLOCK
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

    # ---- 2./3. K1 and K2 against their plain versions ----------------
    errs = {n: 0.0 for n in _kernels()}
    strip = synthetic_pair(STRIP, W, DMIN, DMAX, seed=1)[:2]
    _fused_check("2-3", (("cfg1", _fast_ad(), None),
                         ("fast_ad", _fast_ad(ndir=2, mgm=4), None)),
                 errs, *strip)

    # ---- 4. cfg1 end to end -------------------------------------------
    cfg = _fast_ad()
    pair = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    u, v, d_true = pair
    # per kernel: {main path: launches in that path's run}
    by_path = {n: {} for n in _kernels()}
    got = _stereo_path("4", "cfg1", cfg, pair, FUSED_KERNELS, card, REPS)
    for n in got:
        by_path[n]["cfg1"] = got[n]
    k1_dev = _device_launches(lambda: compute_disparity(u, v, cfg,
                                                        device="cuda"),
                              "fused_wavefront_cluster")
    print(f"[4] K1's device kernel launches in one cfg1 run "
          f"(torch.profiler): {k1_dev} (one a scan direction: "
          f"{got['fused_wavefront']} wrapper calls)", flush=True)
    if k1_dev != got["fused_wavefront"]:
        raise AssertionError(f"K1 launched {k1_dev} device kernels in "
                             f"{got['fused_wavefront']} calls")

    # ---- 5. K1 and K2 at cfg1's full shape ---------------------------
    # (phase 15 times them at cfg2, the numbers of the kernels' record)
    _fused_check("5", (("cfg1", cfg, None),), errs, u, v, RACE_RUNS)
    ms, plain_ms, library_ms, bounds = {}, {}, {}, {}

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
    with tempfile.TemporaryDirectory() as tmp:
        f_in, f_out = os.path.join(tmp, "input.bin"), os.path.join(
            tmp, "labeling.bin")
        mrf_cli.write_problem(f_in, unary, w8)
        for vtype in (0, 1):
            argv = [f_in, f_out, "8", "32", "2", str(vtype)]
            _zero(DENSE_KERNELS)
            torch.cuda.reset_peak_memory_stats()
            if mrf_cli.main(argv) != 0:
                raise AssertionError(f"mrf_cli VTYPE {vtype} failed")
            got = _counts(DENSE_KERNELS)
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
    _zero(DENSE_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, ncc, device="cuda")
    got = _counts(DENSE_KERNELS)
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
    del x

    # ---- 10. K1 and K2 in the V and packed-parity spaces -------------
    _fused_check("10", (("fast_ad V group", _fast_ad(ndir=8), 1),
                        ("fast_ad parity group", _fast_ad(ndir=8, mgm=4), 1)),
                 errs, *synthetic_pair(STRIP, W, DMIN, DMAX, seed=2)[:2])

    # ---- 11. K8 against its plain version at full width -------------
    ut, vt = (torch.from_numpy(a).to(dev).float() for a in (u, v))
    rng = np.random.default_rng(11)
    words = [torch.from_numpy(rng.integers(0, 2**32, (H, W, CENSUS_WORDS),
                                           dtype=np.uint64).astype(np.uint32)
                              .view(np.int32)).to(dev) for _ in range(2)]
    inputs = {"ad": (ut, vt), "sd": (ut, vt), "census": tuple(words),
              "btad": tuple(torch.cat([a, *_bt_aux(a)], -1)
                            for a in (ut, vt))}
    inputs["btsd"] = inputs["btad"]
    e11 = {}
    for mode in cuda_cost.MODES:
        a, b = inputs[mode]
        e11[mode] = _compare(
            f"K8 {mode}",
            cuda_cost.pointwise_volume(a, b, gmin=DMIN, L=L, mode=mode),
            cuda_cost.pointwise_volume_plain(a, b, gmin=DMIN, L=L, mode=mode))
    errs["pointwise_volume"] = max(e11.values())
    print(f"[11] K8 == plain at {H}x{W}, L={L}, ad/sd/btad/btsd on the "
          f"synthetic pair, census on {CENSUS_WORDS} random words a pixel: "
          f"{TOL}, max abs err {e11}", flush=True)
    del inputs, words

    # full_16dir's two K8 calls: ad, each side's left image against the
    # other, 3 channels
    def k8(fn):
        return lambda: (fn(ut, vt, gmin=DMIN, L=L, mode="ad"),
                        fn(vt, ut, gmin=-DMAX, L=L, mode="ad"))

    ms["pointwise_volume"] = _event_ms(k8(cuda_cost.pointwise_volume), 10)
    plain_ms["pointwise_volume"] = _event_ms(
        k8(cuda_cost.pointwise_volume_plain), 2)
    # no single PyTorch call computes a shifted-window distance volume
    library_ms["pointwise_volume"] = None
    # both sides: the (H, W, L) float volume written once, both images
    # read once; per cell 3 channels of subtract, abs and add
    bounds["pointwise_volume"] = _bound(2 * (H * W * L + 2 * H * W * 3) * 4,
                                        2 * H * W * L * 9)
    print(f"[11] pointwise_volume: {ms['pointwise_volume']:.3f} ms, plain "
          f"{plain_ms['pointwise_volume']:.3f} ms, bound "
          f"{bounds['pointwise_volume'][0]:.3f} ms "
          f"({bounds['pointwise_volume'][1]}) for full_16dir's two ad calls "
          f"({H}x{W}x3, L={L}) on {card}", flush=True)
    del ut, vt

    # ---- 12./13. full_16dir and cfg1_tsgm4 end to end ----------------
    rows = {"full_16dir": ("12", _fast_ad(ndir=16),
                           ("fused_wavefront",) + DENSE_KERNELS
                           + ("pointwise_volume",)),
            "cfg1_tsgm4": ("13", _fast_ad(mgm=4), FUSED_KERNELS)}
    for tag, (phase, rcfg, names) in rows.items():
        got = _stereo_path(phase, tag, rcfg, pair, names, card, REPS)
        for n in got:
            by_path[n][tag] = got[n]
        torch.cuda.empty_cache()

    # ---- 14. K1 and K2 at the new rows' full shapes; K1 per front ---
    _fused_check("14", (("full_16dir", _fast_ad(ndir=16), None),
                        ("cfg1_tsgm4", _fast_ad(mgm=4), None)), errs, u, v)
    torch.cuda.empty_cache()
    cfg2 = get_preset("census_tl", dmin=DMIN, dmax=DMAX, test_lr=True)
    for tag, kcfg, group in (("A/B slope 2", _fast_ad(ndir=16), 0),
                             ("V", _fast_ad(ndir=16), 1),
                             ("PB", _fast_ad(mgm=4), 1),
                             ("PA+PB", _fast_ad(ndir=8, mgm=4), 1),
                             ("cfg2 A/B slope 2, census + FH", cfg2, 0),
                             ("cfg2 V, census + FH", cfg2, 1)):
        g = fused.split_passes(kcfg.ndir, kcfg.mgm)[0][group]
        slope, fstep = (1, 2) if g[0] == fused.P_SLOPE else (g[0], 1)
        fronts = len(g[2]) * (fstep * (W - 1) + slope * (H - 1) + 1)
        inp = _k1_inputs(kcfg, u, v)
        gms = _event_ms(lambda: _planes(cuda_fused.fused_wavefront, kcfg,
                                        inp, group), 3)
        print(f"[14] K1 {tag} group of ndir {kcfg.ndir} TSGM {kcfg.mgm} at "
              f"{H}x{W}, L={L}, {2 * len(g[1])} planes: {gms:.3f} ms for "
              f"{fronts} fronts = {gms / fronts * 1e3:.3f} us a front "
              f"on {card}", flush=True)
        del inp

    # ---- 15. K1 and K2 (+ taps) at cfg2's and cfg4's full shapes ------
    # cfg2: census 3x3 (one word a pixel), FH, ndir 8, TSGM 3: A/B at
    # slope 2 and V; these are the kernels' record's times and bounds.
    # cfg4: AD on 3 sobel-x channels truncated at 63*3, FH.
    k1k2 = _fused_timing("15", "cfg2", cfg2, u, v, errs, card)
    for d, part in zip((ms, plain_ms, library_ms, bounds), k1k2):
        d.update(part)
    torch.cuda.empty_cache()
    cfg4 = get_preset("sobelx_tl", dmin=DMIN, dmax=DMAX, test_lr=True)
    _fused_check("15", (("cfg4", cfg4, None),), errs, u, v)
    torch.cuda.empty_cache()

    # ---- 16. K1 and K2 with BT costs and with edge weights -----------
    _fused_check("16", (
        ("bt", get_preset("bt", dmin=DMIN, dmax=DMAX, test_lr=True), None),
        ("cfg2 with weights (aP2 0.5)", cfg2.replace(a_p2=0.5), None),
        ("fast_ad ndir 8 with weights (aP2 0.5)",
         _fast_ad(ndir=8, a_p2=0.5), None)), errs, *strip)

    # ---- 17. cfg2 and cfg4 end to end ---------------------------------
    rows = {"cfg2": ("17", cfg2),
            "cfg4": ("17", cfg4)}
    for tag, (phase, rcfg) in rows.items():
        got = _stereo_path(phase, tag, rcfg, pair, FUSED_KERNELS, card, REPS,
                           tol=0.5)
        for n in got:
            by_path[n][tag] = got[n]
        torch.cuda.empty_cache()

    # ---- 18. the other presets: CUDA == CPU on the crop ---------------
    _crop_check("18", "satellite", get_preset("satellite", test_lr=True),
                u, v)
    for name in ("bt", "full_16dir"):
        _crop_check("18", f"{name} preset", get_preset(
            name, dmin=DMIN, dmax=DMAX, test_lr=True), u, v)

    # ---- 19. K1 under per-pixel windows against its plain version --
    rng = np.random.default_rng(19)
    pp_strip = synthetic_pair(STRIP, W, DMIN, DMAX, seed=19)
    _pp_check("19", (
        ("fast_ad TSGM 2", _fast_ad()),
        ("census_tl", get_preset("census_tl", dmin=DMIN, dmax=DMAX,
                                 test_lr=True)),
        ("FH TSGM 2 unweighted", _fast_ad(use_trunc_linear=True)),
        ("weighted FH TSGM 2 (aP2 0.5)",
         _fast_ad(use_trunc_linear=True, a_p2=0.5))), errs, pp_strip, rng)
    del pp_strip
    torch.cuda.empty_cache()

    # ---- 20. cfg1_mM: per-pixel -m/-M windows end to end --------------
    # bench_matrix's row builds full-band constant images; the second
    # run takes the truth +- 8, clipped to the range (L stays 151)
    wins = {"cfg1_mM": (np.full((H, W), DMIN, np.float32),
                        np.full((H, W), DMAX, np.float32)),
            "cfg1_mM_truth8": tuple(np.clip(d_true + s, DMIN, DMAX).astype(
                np.float32) for s in (-8, 8))}
    for tag, (lo_img, hi_img) in wins.items():
        got = _stereo_path("20", tag, cfg, pair, ("fused_wavefront",), card,
                           NEW_REPS, win=dict(dmin_img=lo_img,
                                              dmax_img=hi_img),
                           absent=("wta",))
        by_path["fused_wavefront"][tag] = got["fused_wavefront"]
    # K1 at cfg1_mM's full shape: a front under per-pixel windows
    inp = _k1_inputs(cfg, u, v)
    full_lo = torch.zeros((2, H, W), dtype=torch.int32, device=dev)
    inp.update(lo_px=full_lo, hi_px=full_lo + (L - 1))
    groups = fused.split_passes(cfg.ndir, cfg.mgm)[0]
    fronts = sum(len(g[2]) * (W + g[0] * (H - 1)) for g in groups)
    k1_mm = _event_ms(lambda: _planes(cuda_fused.fused_wavefront, cfg, inp),
                      3)
    mm_bound = _k1_bound(cfg, inp, 2)
    del inp["lo_px"], inp["hi_px"]
    k1_c = _event_ms(lambda: _planes(cuda_fused.fused_wavefront, cfg, inp),
                     3)
    c_bound = _k1_bound(cfg, inp, 2)
    del inp, full_lo
    print(f"[20] K1 at cfg1's full shape ({H}x{W}, L={L}, {fronts} "
          f"fronts): per-pixel windows {k1_mm:.3f} ms = "
          f"{k1_mm / fronts * 1e3:.3f} us a front, bound with the windows "
          f"read {mm_bound[0]:.3f} ms ({mm_bound[1]}); constant windows "
          f"{k1_c:.3f} ms = {k1_c / fronts * 1e3:.3f} us a front, bound "
          f"{c_bound[0]:.3f} ms ({c_bound[1]}) on {card}", flush=True)
    # K1 against its plain version at cfg1_mM's full shape, under the
    # truth +- 8 windows as compute_disparity hands them to K1
    flo, fhi = stereo._pixel_windows(*wins["cfg1_mM_truth8"], cfg, H, W,
                                     "cuda")
    g_l = int(flo.to(torch.int32).min())
    L_mm = max(int(fhi.to(torch.int32).max()) - g_l, DMAX - DMIN) + 1
    lo_px, hi_px, _, _ = stereo._pp_expand(
        flo, fhi, n_sides=2, gmin_l=g_l, gmin_r=-DMAX, dmin=DMIN, dmax=DMAX)
    inp = _k1_inputs(cfg, u, v)
    inp.update(L=L_mm, sides=((g_l, 0, L_mm - 1), (-DMAX, 0, L_mm - 1)),
               lo_px=lo_px, hi_px=hi_px)
    got, _ = _planes(cuda_fused.fused_wavefront, cfg, inp)
    t, (want, _) = _event_once(lambda: _planes(
        cuda_fused.fused_wavefront_plain, cfg, inp))
    e1 = _compare("K1 cfg1_mM_truth8 full shape", got, want)
    errs["fused_wavefront"] = max(errs["fused_wavefront"], e1)
    print(f"[20] K1 == plain at cfg1_mM_truth8's full shape ({H}x{W}, "
          f"L={L_mm}, both LR sides, left windows truth +- 8, "
          f"{float((hi_px[0] - lo_px[0] < L_mm - 1).float().mean()):.3f} of "
          f"them narrower than the axis): {TOL}, max abs err {e1}, plain "
          f"{t:.1f} ms", flush=True)
    del inp, got, want, flo, fhi, lo_px, hi_px
    torch.cuda.empty_cache()

    # ---- 21. TSGM_ITER = 3 (cfg1, ncc) and TSGM_DEBUG -----------------
    # the label axis grows by 4 * (iterations - 1) on each side
    L_it = L + 2 * 4 * 2
    rows = {"cfg1_iter3": (_fast_ad(iterations=3), FUSED_KERNELS, 0.0),
            "ncc_iter3": (ncc.replace(iterations=3), DENSE_KERNELS, 0.5)}
    for tag, (rcfg, names, tol) in rows.items():
        got = _stereo_path("21", tag, rcfg, pair, names, card, NEW_REPS,
                           tol=tol, L_=L_it)
        for n in got:
            by_path[n][tag] = got[n]
        torch.cuda.empty_cache()
    import contextlib
    import io
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "ENERGY_L1trunc.tif")
        old_dump, stereo.ENERGY_DUMP = stereo.ENERGY_DUMP, dump
        try:
            energies = {}
            for device in ("cuda", "cpu"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    compute_disparity(u[CROP], v[CROP], _fast_ad(
                        iterations=3, debug=True), device=device)
                energies[device] = np.array(
                    [[float(x.split()[-1]) for x in ln.split("\t")]
                     for ln in buf.getvalue().splitlines() if "ENERGY" in ln])
            # a float32 TIFF of the crop: at least its pixels' bytes
            if not (os.path.exists(dump) and os.path.getsize(dump)
                    >= u[CROP].shape[0] * u[CROP].shape[1] * 4):
                raise AssertionError("TSGM_DEBUG wrote no energy image")
        finally:
            stereo.ENERGY_DUMP = old_dump
    ec, ep = energies["cuda"], energies["cpu"]
    rel = float(np.max(np.abs(ec - ep) / np.abs(ep))) if ep.size else 1.0
    print(f"[21] TSGM_DEBUG on a {u[CROP].shape[:2]} crop (cfg1, 3 "
          f"iterations): energies CUDA {ec.tolist()} CPU {ep.tolist()}, max "
          f"relative difference {rel:.3g} (<= 1e-6)", flush=True)
    if ec.shape != (3, 3) or ec.shape != ep.shape or not rel <= 1e-6:
        raise AssertionError("TSGM_DEBUG energies: CUDA and CPU disagree")

    # ---- 22. cfg3_b8 and cfg3_b32: batched pairs ----------------------
    sat = get_preset("satellite", test_lr=True)
    L_sat = SAT_DMAX - SAT_DMIN + 1
    us32, vs32, ds32 = _satellite_pairs(32)
    keys = ("disp", "cost", "disp_right", "cost_right")
    for K in (8, 32):
        tag = f"cfg3_b{K}"
        us, vs = us32[:K], vs32[:K]
        _zero(FUSED_KERNELS)
        compute_disparity(us[0], vs[0], sat, device="cuda")
        one = _counts(FUSED_KERNELS)
        _zero(FUSED_KERNELS)
        torch.cuda.reset_peak_memory_stats()
        res = compute_disparity_batch(us, vs, sat, device="cuda",
                                      outputs=keys)
        got = _counts(FUSED_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if got != one:
            raise AssertionError(f"{tag}: launches {got}, one pair's {one}")
        for n in got:
            by_path[n][tag] = got[n]
        for k in range(K):
            ref = compute_disparity(us[k], vs[k], sat, device="cuda")
            for key in keys:
                _compare(f"{tag} pair {k} {key}", torch.from_numpy(
                    res[key][k]), torch.from_numpy(ref[key]))
        ok = np.isfinite(res["disp"])
        survive = float(ok.mean())
        near = float((np.abs(res["disp"][ok] - ds32[:K][ok]) <= 0.5).mean())
        bw = _walls(lambda: compute_disparity_batch(
            us, vs, sat, device="cuda", outputs=("disp", "cost")), NEW_REPS)
        sw = _walls(lambda: [compute_disparity(
            us[k], vs[k], sat, device="cuda", outputs=("disp", "cost"))
            for k in range(K)], NEW_REPS)
        work = K * 2 * SAT_H * SAT_W * L_sat
        bm, sm = statistics.median(bw), statistics.median(sw)
        print(f"[22] {tag}: {K} pairs {SAT_W}x{SAT_H}x1 L={L_sat} (satellite"
              f" preset, LR) through compute_disparity_batch: launches "
              f"{got} (one pair's), every pair's disp and cost == its own "
              f"compute_disparity on the card ({TOL}), LR survivors "
              f"{survive:.4f}, within 0.5 px {near:.4f}, peak device memory "
              f"{peak:.3f} GiB; batch wall s {bw}, median {bm:.4f} s = "
              f"{work / bm / 1e6:.1f} MP*disp/s; sequential loop median "
              f"{sm:.4f} s = {work / sm / 1e6:.1f} MP*disp/s on {card}",
              flush=True)
        if survive < 0.70 or near < 0.95:
            raise AssertionError(f"{tag} recovery below threshold")
    # K1 and K2 against their plain versions on cfg3_b8's batch (the
    # pair axis, the pair-major ring, K2's n % nsides table)
    lefts, rights, kw = _batch_k1_inputs(sat, us32, vs32, 8)
    got, ns = fused.fused_planes(lefts, rights, **kw)
    t, (want, _) = _event_once(lambda: fused.fused_planes(
        lefts, rights, wavefront=cuda_fused.fused_wavefront_plain, **kw))
    e1 = _compare("K1 cfg3_b8 batch", got, want)
    for run in range(1, RACE_RUNS):
        again, _ = fused.fused_planes(lefts, rights, **kw)
        e1 = max(e1, _compare(f"K1 cfg3_b8 batch run {run}", again, want))
        del again
    del want
    k2 = cuda_fused.wta(got, nspaces=ns, sides=kw["sides"], npair=8,
                        want_taps=True)
    ref = cuda_fused.wta_plain(got, nspaces=ns, sides=kw["sides"], npair=8,
                               want_taps=True)
    torch.cuda.synchronize()
    e2 = max(_compare(f"K2 cfg3_b8 batch {what}", a, b)
             for what, a, b in zip(("disp", "cost", "taps"), k2, ref))
    errs["fused_wavefront"] = max(errs["fused_wavefront"], e1)
    errs["wta"] = max(errs["wta"], e2)
    print(f"[22] K1 == plain in each of {RACE_RUNS} runs on cfg3_b8's "
          f"batch (8 pairs, 16 sides, "
          f"{ns} spaces, {SAT_H}x{SAT_W}, L={L_sat}): {TOL}, max abs err "
          f"{e1}, plain {t:.1f} ms; K2 + taps == plain on those planes: max "
          f"abs err {e2}", flush=True)
    del got, k2, ref
    # K1 a front in a batch of 8 against one pair
    nf = _fronts(kw["groups"], SAT_H, SAT_W)
    k1_b8 = _event_ms(lambda: fused.fused_planes(lefts, rights, **kw), 3)
    lefts, rights, kw = _batch_k1_inputs(sat, us32, vs32, 1)
    k1_b1 = _event_ms(lambda: fused.fused_planes(lefts, rights, **kw), 3)
    print(f"[22] K1 at the satellite geometry ({nf} fronts): K = 8 "
          f"{k1_b8:.3f} ms = {k1_b8 / nf * 1e3:.3f} us a front, K = 1 "
          f"{k1_b1:.3f} ms = {k1_b1 / nf * 1e3:.3f} us a front on {card}",
          flush=True)
    del lefts, rights, kw
    del us32, vs32, ds32
    torch.cuda.empty_cache()

    # ---- 23. cfg3_scene: the tiled runner on an 8x8 mosaic ------------
    su, sv, sd = _satellite_pairs(1, seed0=100)
    su, sv = (np.ascontiguousarray(np.tile(a[0], (8, 8, 1)))
              for a in (su, sv))
    sd = np.tile(sd[0], (8, 8))
    SH, SW = su.shape[:2]
    _zero(FUSED_KERNELS)
    scene = tiled_disparity(su, sv, sat, tile=512, margin=64, batch=5)
    got = _counts(FUSED_KERNELS)
    if min(got.values()) < 1:
        raise AssertionError(f"cfg3_scene bypassed a kernel: {got}")
    for n in got:
        by_path[n]["cfg3_scene"] = got[n]
    single = tiled_disparity(su, sv, sat, tile=512, margin=64, batch=1)
    for key in ("disp", "cost"):
        _compare(f"cfg3_scene batch 5 against batch 1 {key}",
                 torch.from_numpy(scene[key]), torch.from_numpy(single[key]))
    ok = np.isfinite(scene["disp"])
    survive = float(ok.mean())
    near = float((np.abs(scene["disp"][ok] - sd[ok]) <= 0.5).mean())
    tw = _walls(lambda: tiled_disparity(su, sv, sat, tile=512, margin=64,
                                        batch=5), NEW_REPS - 1)
    t1 = _walls(lambda: tiled_disparity(su, sv, sat, tile=512, margin=64,
                                        batch=1), 1)
    work = 2 * SH * SW * L_sat
    tm = statistics.median(tw)
    print(f"[23] cfg3_scene: {SW}x{SH}x1 mosaic (8x8 of a {SAT_W}x{SAT_H} "
          f"pair), L={L_sat}, tiled_disparity(tile=512, margin=64, batch=5):"
          f" {scene['tiles_solved']} tiles solved, launches {got}, batch 5 =="
          f" batch 1 ({TOL}), LR survivors {survive:.4f}, within 0.5 px "
          f"{near:.4f}; wall s {tw}, median {tm:.4f} s = "
          f"{work / tm / 1e6:.1f} MP*disp/s of scene work; batch=1 {t1[0]:.4f}"
          f" s = {work / t1[0] / 1e6:.1f} MP*disp/s on {card}", flush=True)
    if scene["tiles_solved"] != 25 or survive < 0.70 or near < 0.95:
        raise AssertionError("cfg3_scene: tiles or recovery")
    del su, sv, sd, scene, single

    # ---- 24. K4 against its plain version: the sharded recursion ----
    strip_rows = synthetic_pair(STRIP, W, DMIN, DMAX, seed=1)[:2]
    ragged = synthetic_pair(61, W, DMIN, DMAX, seed=5)[:2]
    plain_k4 = _k4_check("24", (
        ("cfg1 A/B stagger, full shape", cfg, (u, v), 2, None),
        ("cfg2 V group (lockstep aprons)", cfg2, strip_rows, 2, 1),
        ("cfg1_tsgm4 PB group (lockstep aprons)", _fast_ad(mgm=4),
         strip_rows, 2, 1),
        ("cfg1, ragged rows", cfg, ragged, 3, None)), errs)
    inp = _k1_inputs(cfg, u, v)
    _zero(("fused_block",))
    _k4_planes(cuda_fused.fused_block, cfg, inp, 2)
    blocks = _counts(("fused_block",))["fused_block"]
    ms["fused_block"] = _event_ms(lambda: _k4_planes(
        cuda_fused.fused_block, cfg, inp, 2), 3)
    plain_ms["fused_block"] = plain_k4[0]
    library_ms["fused_block"] = None
    bounds["fused_block"] = _k4_bound(cfg, inp, 2)
    print(f"[24] fused_block: {ms['fused_block']:.3f} ms for cfg1's sharded "
          f"recursion over 2 ranks of one card ({blocks} blocks of "
          f"{BLOCK} steps = {ms['fused_block'] / blocks:.4f} ms a block), plain "
          f"{plain_ms['fused_block']:.3f} ms, bound "
          f"{bounds['fused_block'][0]:.3f} ms ({bounds['fused_block'][1]}: "
          f"K1's volume, images and tracks) on {card}", flush=True)
    del inp
    torch.cuda.empty_cache()

    # ---- 25. the sharded path end to end ------------------------------
    for tag, rcfg, n, win in (
            ("cfg1_mesh2", cfg, 2, None), ("cfg1_mesh4", cfg, 4, None),
            ("cfg2_mesh2", cfg2, 2, None),
            ("cfg1_tsgm4_mesh2", _fast_ad(mgm=4), 2, None),
            ("cfg1_mM_mesh2", cfg, 2, dict(zip(("dmin_img", "dmax_img"),
                                               wins["cfg1_mM_truth8"])))):
        got = _mesh_path("25", tag, rcfg, pair, n, card, win)
        for k in got:
            by_path[k][tag] = got[k]
        torch.cuda.empty_cache()

    # ---- 26. two processes on the one card ----------------------------
    ref1 = compute_disparity(u, v, cfg, device="cuda")
    by_path["fused_block"]["cfg1_2proc"] = _two_processes(
        "26", "cfg1_2proc", ref1, card)[0]

    # ---- 27. several cards ---------------------------------------------
    if torch.cuda.device_count() > 1:
        from mgm_tpu_torch.parallel import make_mesh

        out = compute_disparity(u, v, cfg, mesh=make_mesh(2))
        for k in ref1:
            _compare(f"cfg1 over cuda:0 and cuda:1 {k}",
                     torch.from_numpy(out[k]), torch.from_numpy(ref1[k]))
        print(f"[27] cfg1 over 2 cards in one process == one card ({TOL})",
              flush=True)
        _two_processes("27", "cfg1_2cards_nccl", ref1, card)
    else:
        print("[27] one card: the mesh over distinct cards and the NCCL "
              "group were not measured", flush=True)
    del ref1

    launches = {n: sum(c.values()) for n, c in by_path.items()}
    print(f"[27] smoke run took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    src = {"fused_wavefront": ("mgm_tpu_torch/csrc/fused_wavefront.cu",
                               "mgm_tpu/ops/pallas_fused.py:692"),
           "wta": ("mgm_tpu_torch/csrc/wta.cu",
                   "mgm_tpu/ops/pallas_fused.py:158"),
           "fused_block": ("mgm_tpu_torch/csrc/fused_block.cu",
                           "mgm_tpu/ops/pallas_fused.py:375"),
           "wavefront_scan": ("mgm_tpu_torch/csrc/wavefront.cu",
                              "mgm_tpu/ops/pallas_wavefront.py:224"),
           "skew": ("mgm_tpu_torch/csrc/skew.cu",
                    "mgm_tpu/ops/pallas_wavefront.py:43"),
           "unskew": ("mgm_tpu_torch/csrc/skew.cu",
                      "mgm_tpu/ops/pallas_wavefront.py:93"),
           "pointwise_volume": ("mgm_tpu_torch/csrc/cost.cu",
                                "mgm_tpu/ops/pallas_cost.py:31")}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1], "launches": launches[n],
         "launches_by_path": by_path[n], "max_abs_err": errs[n],
         "ms": ms[n], "plain_ms": plain_ms[n], "bound_ms": bounds[n][0],
         "bound_by": bounds[n][1], "library_ms": library_ms[n]}
        for n in src]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
