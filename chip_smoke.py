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
    race); then K2's time at cfg1 (no taps) beside its plain version's,
    torch.min's over the summed volume and its bound: the kernels'
    record;
 6. the dense path's kernel K5 (wavefront scan, reading and writing
    image layout through each pass's orientation map: the TPU's skew
    and unskew absorbed into its addressing) against its plain version
    (the TPU's pipeline: canonicalise, skew, front loop, unskew,
    un-canonicalise) on a 64-row strip, 700 wide, L = 151, both LR
    problems: SGM TSGM 2 at slope 1 and 2, weighted FH at TSGM 2 and 3,
    knight passes (ndir 16, TSGM 4) and FH with per-pixel windows:
    bitwise equal;
 7. mgm_o at full width: a 700x500, L = 151 problem with a planted
    labelling (edge weights in {0.25, 1}) written in the mgm_o binary
    protocol, solved by mrf_cli.main (NDIR 8, P1 8, P2 32, MGM 2) for
    VTYPE 0 and 1 through K5 (launch counter; one device launch a pass
    group and no skew or unskew kernel, by torch.profiler), >= 95 % of
    the planted labels recovered, peak device memory, a crop equal to
    its CPU run, and the median wall time in MP*disp/s (H*W*L / s);
 8. the `ncc` preset at cfg1 geometry on the synthetic pair, LR both
    ways, through K5: >= 70 % of pixels survive the LR check and >= 95 %
    of those lie within 0.5 px of the true disparity; peak device
    memory; a crop equal to its CPU run; the median wall time in
    MP*disp/s; then K5's device kernel launches in one run, counted by
    torch.profiler: one a pass group (4), and no skew or unskew kernel;
 9. K5 against its plain version at the NCC run's largest pass group
    (the shapes the main path gives it): bitwise equal in each of
    RACE_RUNS runs; then its time (and a front) beside its plain
    version's and its bound, and the TPU's skew and unskew in plain
    PyTorch and as one library copy at that group's shapes; then K5
    against its plain version once at full_16dir's column knight group
    (8 planes, 700x500, random costs) and at mgm_o's weighted FH group
    (VTYPE 1: the diagonal column group of the planted problem, 2
    planes at slope 2), with its time a front;
10. K1 and K2 against their plain versions on a 64-row strip, 700
    wide, L = 151, both LR sides, for the V group (ndir 8, TSGM 2,
    slope 0) and the packed-parity group (ndir 8, TSGM 4, PA + PB):
    bitwise equal;
11. K8 (the finished cost volume: raw costs, truncation, windows and
    the all-invalid rule in one pass) against its plain version
    (build_cost_volume's composition) at 700x500, L = 151, for ad, sd,
    btad, btsd and census (random packed words), NaN pixels, windows
    the truth +- 8 with every 7th empty, and written into a slice of a
    stack: bitwise equal; then, at full_16dir's two sides (the full
    band), the kernel's call and the `_dense_cc` stage held bitwise
    against the plain version and their times beside its plain
    version's and its bound; then, by torch.profiler in
    a process of its own, K2 one device launch a call (cfg1, cfg2 +
    taps) and the `_dense_cc` stage two K8 launches and no other kernel
    over a volume;
12. full_16dir (bench_matrix's row: fast_ad at ndir 16, TSGM 2) end to
    end as phase 4, through K1 (A/B and V groups), K8 and K5 on the
    knight passes (launch counters; K5 one device launch a knight group
    and no skew or unskew kernel, by torch.profiler);
13. cfg1_tsgm4 (fast_ad at TSGM 4: A and PB groups) end to end as
    phase 4, through K1 and K2;
14. K1 and K2 against their plain versions for full_16dir (A/B at
    slope 2 and V into one volume) and cfg1_tsgm4 (A at slope 2 and PB)
    on the 64-row strip, 700 wide (at the full shape the plain K1 takes
    15-18 s a case): bitwise equal; then K1's time
    per front of each group at full width: A/B at slope 2, V, PB, PA +
    PB, and cfg2's A/B and V groups (census, FH);
15. K1 and K2 (+ taps) against their plain versions for cfg2
    (census_tl over -120..30: 3x3 census words, FH, ndir 8, TSGM 3, A/B
    at slope 2 and V, both LR sides) on the 64-row strip, 700 wide (at
    the full shape the plain K1 takes about a minute), K1 in each of
    RACE_RUNS runs, and K2 (+ taps) also at the full shape: bitwise
    equal; then at the full shape each one's time (K1's plain time and
    its own on the strip beside it), K2's beside its plain version's
    and torch.min's, and their
    bounds (K1's record; K2's `cfg2_taps`); then the same check for
    cfg4 (sobelx_tl: AD on 3 float channels truncated at 63*3, FH,
    ndir 8, TSGM 3) on the strip;
16. K1 and K2 against their plain versions on the 64-row strip, 700 wide,
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
    over in-process ranks on the one card (each rank on its own
    stream), K4's run in each of RACE_RUNS runs bitwise equal to K1's
    unsharded volume: the A/B stagger (cfg1), cfg2's V group (census,
    FH) and cfg1_tsgm4's PB group (lockstep aprons) over 2 ranks, at
    the full 700x500, L = 151 and on a 64x256 strip, where the whole
    sharded recursion is also held bitwise against its plain version
    (at the full shape the plain recursion takes 10-20 s a case, and
    K1, the same kernel body, is held against its plain version at the
    full width in phases 2-20); cfg1
    on a 61x256 strip over 3 ranks (21 + 21 + 19 rows) in blocks of 4
    steps (the halo ring wraps many times) against both; then K4's
    device launches in one sharded cfg1 recursion, counted by
    torch.profiler in a process of its own: one a call; then its time
    for that recursion and its bound, and its time on the strip beside
    its plain version's;
25. the sharded path end to end: compute_disparity(mesh=make_mesh(
    devices=["cuda:0"] * n)) for cfg1 at n = 2 and 4, and cfg2,
    cfg1_tsgm4 and cfg1_mM at n = 2, every output bitwise equal to the
    unsharded run's, through K4 and K2 (K1 not launched), the median
    wall of NEW_REPS runs beside the unsharded one's, in MP*disp/s,
    and peak memory (n ranks on one card, each on its own stream and
    K4's plan on 1/n of the card: an emulation of n cards, not a
    multi-card measurement);
26. two processes on the one card (gloo; NCCL refuses two ranks on one
    GPU, and gloo takes CPU tensors, so the tracks go through host
    memory): cfg1 through parallel.distributed's
    compute_disparity_distributed, each process's outputs bitwise
    equal to the single-process run, and its wall;
27. with more than one card: the in-process mesh over distinct cards
    and the NCCL group (one line saying that they were not measured
    otherwise);
28. K5 on a band (the dense recursion on one rank's band of canonical
    rows, csrc/wavefront_band.cu: a block of fronts a launch, the halo
    ring of the rank upstream, parallel/halo.py) against its plain
    version over in-process ranks on the one card (each rank on its own
    stream), the whole sharded recursion held bitwise in each of
    RACE_RUNS runs, and against the unsharded K5, at L = 151 on strips
    of 96 columns: every group kind (ndir 16: axis slope 1, diagonal
    slope 2 and knight passes, both flow signs, row and column bands)
    and weighted FH (mgm_o VTYPE 1) over 2 ranks on 40 rows, weighted FH
    restricted to windows at TSGM 3 in blocks of 4 fronts over 3 ranks
    on 20 rows, and 9 rows over 4 ranks (the last without a row); at
    full width phase 29 holds it against the unsharded K5;
29. ncc_mesh2: the `ncc` preset at cfg1 geometry over 2 in-process
    ranks of the card (one-card emulation, as phase 25): every output
    bitwise equal to the unsharded run's, through K5 on a band (K5 and
    K1 not launched), the walls, the card's peak memory; K5-band's
    device launches in one run, counted by torch.profiler in a process
    of its own (one a block, no launch a front), their device time, the
    run's wall and the card's busy share, and there each rank's peak
    memory (the caching allocator's trace, by the stream that
    allocated) beside the unsharded run's; the sharded recursion at
    full width bitwise equal to the unsharded K5's, its time beside the
    unsharded K5's and its bound (the kernels' record), its time on
    phase 28's first strip beside its plain version's;
30. full_16dir_mesh2: full_16dir over 2 ranks: K4 (fused groups), K8
    (each band's volumes) and K5 on a band (knight passes), every output
    bitwise equal to the unsharded run's;
31. mgm_o_mesh2: parallel.solve_tiled on the mgm_o problem (700x500,
    L = 151, NDIR 8, MGM 2, VTYPE 0 and 1) over 2 ranks: the labels
    bitwise equal to mrf.solve_mrf's on the card, through K5 on a band.
    Each phase prints its start time (`t = ... s`).

The kernels build in a child process below this one's priority; in the
meantime a thread here makes the plain runs of the kernel-against-plain
checks (the card is idle then), keeps them on the host and stops when
the build ends; the checks make the plain runs it did not reach.  A
plain time made then says so: the compiler shares the host's cores.
The plain times of the kernels' record are made after the build.

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
(phases 7-8) and ncc_iter3 (phase 21) for K5, full_16dir (phase 12) for
K1, K5 and K8, the sharded rows (phase 25) for K4 and K2, and the
dense mesh rows (phases 29-31: ncc_mesh2, full_16dir_mesh2 for K4, K8
and K5-band, the two mgm_o_mesh2 runs) for K5 on a band; `launches` is
their sum.  The entries `skew` and `unskew` (the TPU's K6
and K7) are absorbed into K5's addressing: no kernel of theirs exists,
so they launch 0 times on every path K5 runs; their max_abs_err is K5's
group checks', their `ms`, `bound_ms` and `bound_by` are null (nothing
runs or moves for them), and `plain_ms` / `library_ms` are the plain
skew and unskew and one strided copy at the NCC group's shapes.  K4's times and bound are the sharded cfg1
recursion's over 2 ranks (phase 24), K5-band's ncc_mesh2's sharded
recursion's over 2 ranks (phase 29), also under the K5 record's `band`.
K1's, K4's and K5-band's plain times are a strip's (`plain_at`), with
the kernel's own time on that strip beside them (`strip_ms`).  One K1
call is one cluster launch that steps every front of its scan direction inside the kernel; one K4
call is one launch of the same kernel body on a band that steps a
block's fronts inside the kernel; one K5 call is one launch that steps
every front of its pass group inside the kernel; one K5-band call is
one launch of K5's kernel on a band that steps a block's fronts; one
K2 call is one persistent launch over runs of pixels; one K8 call is one launch a
volume.  K1's times and bounds are cfg2's (phase 15), K2's cfg1's
(phase 5; cfg2's with taps, phase 15, under `cfg2_taps`), K8's
full_16dir's two sides (phase 11).  `bound_ms` is the larger of the
bytes the call must move over 3.35 TB/s and its float32 operations over
67 TFLOP/s (the H100 SXM's published peaks).
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
# (the main paths' full width: the width sets the fronts and how each
# row's ring wraps).  Phase 24's K4 strips are narrower: K4 at the full
# shape is held against K1, which is held against plain at full width.
K4_STRIP_W = 256
BAND_STRIP = (40, 96)            # phase 28's K5-band strips (rows, columns)
CROP = (slice(100, 148), slice(200, 296))  # the CUDA-against-CPU crop
BUILD_NICE = 10                  # the compiler's priority below this one's
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
DENSE_KERNELS = ("wavefront_scan",)
# the TPU's skew and unskew (K6, K7), absorbed into K5's addressing
ABSORBED = ("skew", "unskew")
FUSED_KERNELS = ("fused_wavefront", "wta")
CENSUS_WORDS = 2                 # phase 11's packed census words a pixel
NEW_REPS = 2                     # timed runs of phases 20-31
RACE_RUNS = 3                    # K1 / K4 / K5 runs held against one plain run
K5_KERNEL = "wavefront_rows"     # K5's device kernel (csrc/wavefront.cu)
K5B_KERNEL = "wavefront_rows<true"  # K5 on a band's (template flag BAND)
K4_KERNEL = "fused_block_cluster"  # K4's (csrc/fused_wavefront.cuh)
K8_KERNEL = "cost_volume_kernel"   # K8's (csrc/cost.cu)
K2_KERNEL = "wta_runs"             # K2's (csrc/wta.cu)
LAUNCH_REPS = 1                  # runs counted by the profiler, phase 11
SHARD_KERNELS = ("fused_block", "wta")
BAND_KERNELS = ("wavefront_band",)
# the dense mesh rows' kernels: K5 on a band and not K5, nor K1
DENSE_ABSENT = ("wavefront_scan", "fused_wavefront")
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
    """Copies of 32-bit words: every bit equal, NaN payloads too."""
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


# plain runs made while the kernels build (the card idles then):
# key -> (ms, result on the host)
_AHEAD: dict = {}


def _to(obj, dev):
    """obj with every tensor in it (in tuples, lists, dicts) on `dev`."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(o, dev) for k, o in obj.items()}
    return obj


def _plain(key, fn, jobs=None):
    """A check's plain run fn() -> (ms, result).  With `jobs` (a list)
    it is queued there under `key` for _build_ahead; else (ms, result
    on the card, whether it ran while the kernels built), from _AHEAD
    when it ran there, run now otherwise."""
    if jobs is not None:
        jobs.append((key, fn))
        return None
    if key in _AHEAD:
        t, res = _AHEAD.pop(key)
        return t, _to(res, "cuda"), True
    return (*fn(), False)


def _while_built(ahead: bool) -> str:
    return " (run while the kernels built)" if ahead else ""


def _build_ahead(jobs):
    """Builds the kernels in a child process below this one's priority
    while a thread here runs the plain jobs (key, fn) in order, each
    result kept in _AHEAD on the host; when the build ends the thread
    stops after the job in hand, and the checks run the rest
    themselves.  Returns (the library, the build's seconds, the jobs
    done)."""
    import threading
    from mgm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from mgm_tpu_torch.ops import _build; _build.build()", REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(BUILD_NICE))
    halt, fault = threading.Event(), []

    def run():
        try:
            for key, fn in jobs:
                if halt.is_set():
                    return
                t, res = fn()
                _AHEAD[key] = (t, _to(res, "cpu"))
        except BaseException as e:   # raised again in the main thread
            fault.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    log = child.communicate()[0]
    secs = time.perf_counter() - t0
    halt.set()
    th.join()
    if fault:
        raise fault[0]
    if child.returncode != 0:
        print(log[-4000:], flush=True)
    return _build.build(), secs, len(_AHEAD)


def _device_kernels(fn, reps: int = 1) -> dict:
    """{device kernel name: [launches, device ms]} of `reps` fn() runs,
    by torch.profiler.  Small kernels of its own run before and after
    them, with a pause: on the H100 the profiler has missed kernels
    launched as it started or stopped (one of two K8 launches, a lone
    K2 launch), and then it misses those."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def pad():
        x = torch.zeros(256, device="cuda")
        for _ in range(8):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.02)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        pad()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = out.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def _device_launches(fn, name: str, reps: int = 1) -> int:
    """The device kernels whose name holds `name` that `reps` fn() runs
    launch, by torch.profiler."""
    return sum(c for k, (c, _) in _device_kernels(fn, reps).items()
               if name in k)


def _dense_device(phase, tag, fn, calls: int, groups: int) -> None:
    """One run of a dense path, fn, under torch.profiler: K5 one device
    launch a pass group (`calls` wrapper calls in the counted run, the
    path's `groups` pass groups)."""
    k5 = _device_launches(fn, K5_KERNEL)
    print(f"[{phase}] {tag}: K5's device kernel launches in one run "
          f"(torch.profiler) {k5} (one a pass group: {calls} wrapper calls,"
          f" {groups} groups)", flush=True)
    if not k5 == calls == groups:
        raise AssertionError(f"{tag}: K5 launched {k5} device kernels in "
                             f"{calls} calls for {groups} pass groups")


def _stamp(phase, t_start) -> None:
    """The seconds since the script's start, at a phase's start."""
    print(f"[{phase}] t = {time.perf_counter() - t_start:.1f} s",
          flush=True)


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
            "wavefront_band": wf.wavefront_band,
            "pointwise_volume": cuda_cost.cost_volume}


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


def _dense_strip(i, jobs=None):
    """Phase 6, case DENSE_CASES[i]: K5 against its plain version on the
    same image-layout inputs, made from the case's own seed; returns
    K5's max abs error and the case's plan (with `jobs`: queues the
    plain run, _plain)."""
    import torch
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf

    what, ndir, mgm, fh, wts, restrict, pick = DENSE_CASES[i]

    def inputs():
        rng = np.random.default_rng((6, i))
        N = 2
        lo = np.zeros((N, STRIP, W), np.int32)
        hi = np.full((N, STRIP, W), L - 1, np.int32)
        if restrict:
            lo = rng.integers(0, L - 2, lo.shape).astype(np.int32)
            hi = (lo + rng.integers(1, L - 1, lo.shape)).clip(max=L - 1)
            hi = hi.astype(np.int32)
        cc = rng.uniform(0, 50, (N, STRIP, W, L)).astype(np.float32)
        inw = ((np.arange(L) >= lo[..., None])
               & (np.arange(L) <= hi[..., None]))
        cc = np.where(inw, cc, np.inf).astype(np.float32)
        w8 = np.where(rng.random((N, STRIP, W, 8)) < 0.5, 0.25,
                      1.0).astype(np.float32)
        pids = agg._pass_groups(ndir, mgm)[pick]
        plan = agg.group_plan(pids, STRIP, W, mgm)
        args = tuple(torch.from_numpy(a).cuda() for a in (cc, w8, lo, hi))
        kw = agg.scan_kwargs(plan, p1=8.0 * 3, p2=32.0 * 3, mgm=mgm,
                             use_fh=fh, use_weights=wts,
                             fh_restrict=restrict)
        return args, kw, plan

    def plain():
        args, kw, _ = inputs()
        return _event_once(lambda: wf.wavefront_scan_plain(*args, **kw))

    if jobs is not None:
        return _plain(("K5", i), plain, jobs)
    args, kw, plan = inputs()
    out = wf.wavefront_scan(*args, **kw)
    _, ref, _ = _plain(("K5", i), plain)
    torch.cuda.synchronize()
    return _compare(f"K5 [{what}]", out, ref), plan


def _dense_path_device(phase, tag, cfg, pair, got):
    """_dense_device for a stereo row through K5 on `pair` (its dense
    passes: every pass of an NCC run a solve, the fused
    solve's leftovers otherwise)."""
    from mgm_tpu_torch import compute_disparity
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import fused

    u, v = pair[:2]
    pids = (None if cfg.distance == "ncc"
            else fused.split_passes(cfg.ndir, cfg.mgm)[1])
    groups = len(agg._pass_groups(cfg.ndir, cfg.mgm, pids)) * (
        cfg.iterations if cfg.distance == "ncc" else 1)
    _dense_device(phase, tag, lambda: compute_disparity(
        u, v, cfg, device="cuda"), got["wavefront_scan"], groups)


def _fused_check(phase, cases, errs, u, v, runs=1, jobs=None):
    """K1 and K2 (with the subpixel taps) against their plain versions
    on the uint8 pair (u, v), both LR sides, for each (label, cfg,
    group) case (group None: every fused group of the solve), K1 in
    each of `runs` runs; folds the max abs errors into `errs` and
    returns each case's plain K1 time (ms, one run).  With `jobs`:
    queues the plain runs (_plain) and checks nothing."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused, fused

    plain_ms = []
    for label, cfg, group in cases:
        key = ("K1", label, u.shape, group)

        def plain(cfg=cfg, group=group):
            inp = _k1_inputs(cfg, u, v)
            return _event_once(lambda: _planes(
                cuda_fused.fused_wavefront_plain, cfg, inp, group)[0])

        if jobs is not None:
            _plain(key, plain, jobs)
            continue
        inp = _k1_inputs(cfg, u, v)
        if cfg.a_p2 != 1.0 and inp["w8"] is None:
            raise AssertionError(f"{label}: every edge weight is 1")
        got, ns = _planes(cuda_fused.fused_wavefront, cfg, inp, group)
        t, want, ahead = _plain(key, plain)
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
              f"max abs err {e1}, plain {t:.1f} ms{_while_built(ahead)}; "
              f"K2 + taps == plain on those planes ({ns} spaces): max abs "
              f"err {e2}", flush=True)
        del got, k2, ref
    return plain_ms


def _fused_timing(phase, tag, cfg, u, v, strip, errs, card):
    """K1 and K2 (+ taps) of cfg: checked against their plain versions
    on the full-width strip (_fused_check; at the full shape the plain
    K1 takes about a minute), K2 (+ taps) also at the full shape of (u,
    v); then at the full shape each one's time beside its plain
    version's (K1's plain time the strip's, beside K1's own there), K2's
    beside torch.min over the summed volume, and their bounds.  Returns
    (ms, plain_ms, library_ms, bounds, K1's ms on the strip), the first
    four {kernel name: value}."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused

    plain_ms = {"fused_wavefront": _fused_check(phase, ((tag, cfg, None),),
                                                errs, *strip, RACE_RUNS)[0]}
    inp = _k1_inputs(cfg, *strip)
    strip_ms = _event_ms(lambda: _planes(cuda_fused.fused_wavefront, cfg,
                                         inp), 3)
    inp = _k1_inputs(cfg, u, v)
    ms = {"fused_wavefront": _event_ms(lambda: _planes(
        cuda_fused.fused_wavefront, cfg, inp), 3)}
    vol, ns = _planes(cuda_fused.fused_wavefront, cfg, inp)
    got = cuda_fused.wta(vol, nspaces=ns, sides=inp["sides"], want_taps=True)
    ref = cuda_fused.wta_plain(vol, nspaces=ns, sides=inp["sides"],
                               want_taps=True)
    torch.cuda.synchronize()
    errs["wta"] = max([errs["wta"]] + [
        _compare(f"K2 {what} {tag} full shape", a, b)
        for what, a, b in zip(("disp", "cost", "taps"), got, ref)])
    del got, ref
    print(f"[{phase}] K2 + taps == plain at {tag}'s full shape ({TOL})",
          flush=True)
    library_ms = {"fused_wavefront": None}
    bounds = {"fused_wavefront": _k1_bound(cfg, inp, ns)}
    (ms["wta"], plain_ms["wta"], library_ms["wta"],
     bounds["wta"]) = _k2_timing(phase, tag, vol, ns, inp["sides"], True,
                                 card)
    del vol
    n_sides = len(inp["sides"])
    name = "fused_wavefront"
    print(f"[{phase}] {name}: {ms[name]:.3f} ms, bound "
          f"{bounds[name][0]:.3f} ms "
          f"({bounds[name][1]}) at {tag}'s shapes ({ns * n_sides} planes "
          f"{H}x{W}, L={inp['L']}; every fused group, forward + backward "
          f"launch); on the {strip[0].shape[0]}x{strip[0].shape[1]} strip "
          f"{strip_ms:.3f} ms, plain {plain_ms[name]:.3f} ms on {card}",
          flush=True)
    return ms, plain_ms, library_ms, bounds, strip_ms


def _k2_timing(phase, tag, vol, ns, sides, taps, card):
    """K2 on K1's volume `vol` (ns spaces): its device time, its plain
    version's, torch.min's
    over the summed volume (computes less: no space sum, no window, no
    taps) and its bound.  Returns (ms, plain_ms, library_ms, (bound_ms,
    bound_by))."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused

    def k2():
        return cuda_fused.wta(vol, nspaces=ns, sides=sides, want_taps=taps)

    ms = _event_ms(k2, 10)
    plain = _event_ms(lambda: cuda_fused.wta_plain(
        vol, nspaces=ns, sides=sides, want_taps=taps), 3)
    n_sides = len(sides)
    ssum = vol[:n_sides]
    for si in range(1, ns):
        ssum = ssum + vol[si * n_sides:(si + 1) * n_sides]
    lib = _event_ms(lambda: torch.min(ssum, dim=-1), 10)
    del ssum
    # the volume read once; disp and cost (and the 4 taps) written; per
    # cell the space sum and the windowed compare
    outs = (6 if taps else 2) * n_sides * H * W * 4
    bound = _bound(vol.numel() * 4 + outs, 2 * vol.numel())
    print(f"[{phase}] wta (K2{' + taps' if taps else ''}) at {tag}: "
          f"{ms:.4f} ms, plain {plain:.3f} ms, "
          f"torch.min over the summed volume {lib:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}): {bound[0] / ms:.1%} of it "
          f"({ns} spaces x {n_sides} sides, {H}x{W}, L={vol.shape[-1]}) on "
          f"{card}", flush=True)
    return ms, plain, lib, bound


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


def _pp_check(phase, cases, errs, strip, jobs=None):
    """K1 under per-pixel windows against its plain version, bitwise, on
    the strip (u, v, truth), both LR sides, for each (label, cfg) case
    with the fh_restrict rule of ops/fused.mgm_solve_fused, the windows
    from the case's own seed.  With `jobs`: queues the plain runs
    (_plain) and checks nothing."""
    from mgm_tpu_torch.ops import cuda_fused

    u, v, d = strip
    for i, (label, cfg) in enumerate(cases):
        def inputs(cfg=cfg, i=i):
            inp = _k1_inputs(cfg, u, v)
            lo, hi = _index_windows(d, cfg, np.random.default_rng((19, i)))
            restrict = (cfg.use_trunc_linear
                        and not (cfg.mgm == 2 and inp["w8"] is None))
            inp.update(lo_px=lo, hi_px=hi, fh_restrict=restrict)
            return inp

        def plain(cfg=cfg, inputs=inputs):
            inp = inputs()
            return _event_once(lambda: _planes(
                cuda_fused.fused_wavefront_plain, cfg, inp)[0])

        key = ("K1 per-pixel", label)
        if jobs is not None:
            _plain(key, plain, jobs)
            continue
        inp = inputs()
        lo, hi = inp["lo_px"], inp["hi_px"]
        got, _ = _planes(cuda_fused.fused_wavefront, cfg, inp)
        t, want, ahead = _plain(key, plain)
        e1 = _compare(f"K1 per-pixel {label}", got, want)
        errs["fused_wavefront"] = max(errs["fused_wavefront"], e1)
        print(f"[{phase}] K1 == plain under per-pixel windows at "
              f"{u.shape[0]}x{u.shape[1]}x3, L={inp['L']}, {label}: ndir "
              f"{cfg.ndir} TSGM {cfg.mgm}, {cfg.distance}, "
              f"{'FH' if cfg.use_trunc_linear else 'SGM'}, weights "
              f"{'on' if inp['w8'] is not None else 'off'}, fh_restrict "
              f"{inp['fh_restrict']} (windows truth +- 6, "
              f"{float((hi - lo == 0).float().mean()):.3f} one label, "
              f"{float((hi < lo).float().mean()):.3f} empty): {TOL}, max abs "
              f"err {e1}, plain {t:.1f} ms{_while_built(ahead)}", flush=True)
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


def _batch_plain(cfg, K):
    """(ms, volume) of K1's plain version on the batch of the first K
    satellite pairs (_batch_k1_inputs)."""
    from mgm_tpu_torch.ops import cuda_fused, fused

    us, vs, _ = _satellite_pairs(K)
    lefts, rights, kw = _batch_k1_inputs(cfg, us, vs, K)
    return _event_once(lambda: fused.fused_planes(
        lefts, rights, wavefront=cuda_fused.fused_wavefront_plain, **kw)[0])


def _fronts(groups, R, C):
    """Fronts of one K1 pass over the groups at R x C."""
    from mgm_tpu_torch.ops import fused

    n = 0
    for gslope, _, launches in groups:
        slope, fstep = (1, 2) if gslope == fused.P_SLOPE else (gslope, 1)
        n += len(launches) * (fstep * (C - 1) + slope * (R - 1) + 1)
    return n


def _k4_planes(fn, cfg, inp, n, group=None, block=None):
    """The sharded recursion of cfg's fused groups (or group number
    `group` alone) over n in-process ranks on the card through `fn`
    (K4 or its plain version) in blocks of `block` steps (the default
    when None), with _k1_inputs' `inp`: ({rank: (r0, volume)},
    nspaces)."""
    from mgm_tpu_torch.ops import fused
    from mgm_tpu_torch.parallel import make_mesh, sharded_fused_planes

    groups = fused.split_passes(cfg.ndir, cfg.mgm)[0]
    if group is not None:
        groups = groups[group:group + 1]
    kw = dict(inp)
    return sharded_fused_planes(kw.pop("lefts"), kw.pop("rights"),
                                mesh=make_mesh(devices=["cuda:0"] * n),
                                groups=groups, kernel=fn, block=block,
                                kappa=-float(cfg.ndir - 1), **kw)


def _k4_launch_worker() -> int:
    """Phase 24's count of K4's device kernels, in a process of its own:
    one sharded cfg1 recursion over 2 ranks (after a warm one) under
    torch.profiler; prints its kernels and its wrapper calls as JSON."""
    sys.path.insert(0, REPO)
    import torch
    from mgm_tpu_torch.ops import cuda_fused
    from mgm_tpu_torch.synthetic import synthetic_pair

    u, v, _ = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    cfg = _fast_ad()
    inp = _k1_inputs(cfg, u, v)
    _k4_planes(cuda_fused.fused_block, cfg, inp, 2)
    torch.cuda.synchronize()
    cuda_fused.fused_block.launches = 0
    device = _device_launches(lambda: _k4_planes(
        cuda_fused.fused_block, cfg, inp, 2), K4_KERNEL)
    print(json.dumps({"calls": cuda_fused.fused_block.launches,
                      "device": device}), flush=True)
    return 0


def _launches_process(flag: str) -> dict:
    """Runs this script with `flag` (a launch-count worker) in a process
    of its own; the JSON record it prints last."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode != 0 or not lines:
        raise AssertionError(f"the launch count {flag} failed "
                             f"({res.returncode}):\n{res.stdout[-2000:]}"
                             f"{res.stderr[-2000:]}")
    return json.loads(lines[-1])


def _k4_check(phase, cases, errs, runs, jobs=None):
    """K4 against K1's unsharded volume in each of `runs` runs, and
    against its plain version (the whole sharded recursion, one plain
    run) where the case asks, bitwise, for each (label, cfg, pair,
    ranks, group, block, plain) case; returns the plain cases' plain
    times (ms, one run).  With `jobs`: queues the plain runs (_plain)
    and checks nothing."""
    import torch
    from mgm_tpu_torch.ops import cuda_fused

    plain_ms = []
    for label, cfg, (u, v), n, group, block, plain in cases:
        def run_plain(cfg=cfg, u=u, v=v, n=n, group=group, block=block):
            inp = _k1_inputs(cfg, u, v)
            return _event_once(lambda: _k4_planes(
                cuda_fused.fused_block_plain, cfg, inp, n, group, block)[0])

        if jobs is not None:
            if plain:
                _plain(("K4", label), run_plain, jobs)
            continue
        inp = _k1_inputs(cfg, u, v)
        want, t, ahead = None, None, False
        if plain:
            t, want, ahead = _plain(("K4", label), run_plain)
            plain_ms.append(t)
        ref, _ = _planes(cuda_fused.fused_wavefront, cfg, inp, group)
        err, rows = 0.0, []
        for run in range(runs):
            got, ns = _k4_planes(cuda_fused.fused_block, cfg, inp, n, group,
                                 block)
            rows = []
            for k in sorted(got):
                r0, vol = got[k]
                if plain:
                    err = max(err, _compare(f"K4 {label} run {run} rank "
                                            f"{k}", vol, want[k][1]))
                _compare(f"K4 {label} run {run} rank {k} against K1",
                         vol, ref[:, r0:r0 + vol.shape[1]])
                rows.append(vol.shape[1])
            del got
        errs["fused_block"] = max(errs["fused_block"], err)
        print(f"[{phase}] K4 sharded over {n} ranks of the card (rows "
              f"{rows}, blocks of {block or 'the default'} steps), {label}:"
              f" {u.shape[0]}x{u.shape[1]}x3, L={inp['L']}, ndir {cfg.ndir}"
              f" TSGM {cfg.mgm}, {cfg.distance}, "
              f"{'FH' if cfg.use_trunc_linear else 'SGM'}, {ns} spaces: "
              f"every band == K1's unsharded volume in each of {runs} runs"
              + (f"; == plain in each ({TOL}), max abs err {err}, plain "
                 f"{t:.1f} ms{_while_built(ahead)}" if plain else "")
              + f" ({TOL})", flush=True)
        del want, ref, inp
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


def _mesh_path(phase, tag, cfg, pair, n, card, win=None, names=None,
               absent=("fused_wavefront",)):
    """compute_disparity over n in-process ranks on the card: every
    output bitwise equal to the unsharded run's, the kernels `names`
    launched (default K4 and, with constant windows, K2), those of
    `absent` not (default K1); the median walls of NEW_REPS runs,
    sharded and unsharded.  Returns the launch counts."""
    import torch
    from mgm_tpu_torch import compute_disparity
    from mgm_tpu_torch.parallel import make_mesh

    u, v, _ = pair
    win = win or {}
    mesh = make_mesh(devices=["cuda:0"] * n)
    ref = compute_disparity(u, v, cfg, device="cuda", **win)
    names = names or (("fused_block",) if win else SHARD_KERNELS)
    _zero(tuple(_kernels()))
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, cfg, mesh=mesh, **win)
    got = _counts(names)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if min(got.values()) < 1 or any(_counts(absent).values()):
        raise AssertionError(f"{tag}: the sharded run bypassed one of "
                             f"{names} or launched one of {absent}: {got}, "
                             f"{_counts(absent)}")
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
          f"{peak:.3f} GiB (the card's: its {n} ranks together); wall s "
          f"{walls}, median {med:.4f} s = "
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


def _k8_check(u, v, d_true, dev):
    """K8 (cuda_cost.cost_volume) bitwise against its plain version
    (build_cost_volume's plain composition, cuda_cost.cost_volume_plain)
    at 700x500, L = 151 in every family: the synthetic pair with NaN
    pixels (census: random words), per-pixel windows the truth +- 8 with
    every 7th pixel's empty, finite and infinite truncations, and once
    through build_cost_volume into a slice of a stack; returns the max
    abs err."""
    import torch
    from mgm_tpu_torch.ops import cuda_cost
    from mgm_tpu_torch.ops.cost import _bt_aux, build_cost_volume

    ut, vt = (torch.from_numpy(a).to(dev).float() for a in (u, v))
    ut[::37, ::41], vt[5::53, ::29] = float("nan"), float("nan")
    rng = np.random.default_rng(11)
    words = tuple(torch.from_numpy(
        rng.integers(0, 2**32, (H, W, CENSUS_WORDS), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev) for _ in range(2))
    bt = tuple(torch.cat([a, *_bt_aux(a)], -1) for a in (ut, vt))
    lo = np.floor(d_true).astype(np.int32) - 8 - DMIN
    hi = lo + 16
    hi.reshape(-1)[::7] = lo.reshape(-1)[::7] - 1
    lo, hi = (torch.from_numpy(a).to(dev) for a in (lo, hi))
    # (images, truncation per channel) of each family
    cases = {"ad": ((ut, vt), float("inf")), "sd": ((ut, vt), 900.0),
             "census": (words, 0.25), "btad": (bt, float("inf")),
             "btsd": (bt, 40.0)}
    errs = {}
    for mode, ((a, b), trunc) in cases.items():
        kw = dict(gmin=DMIN, L=L, mode=mode, tmax=trunc * a.shape[-1]
                  / (3 if mode in ("btad", "btsd") else 1))
        errs[mode] = _compare(f"K8 {mode}",
                              cuda_cost.cost_volume(a, b, lo, hi, **kw),
                              cuda_cost.cost_volume_plain(a, b, lo, hi, **kw))
    stack = torch.full((2, H, W, L), -1.0, device=dev)
    build_cost_volume(vt, ut, lo, hi, -DMAX, distance="ad", L=L,
                      trunc_dist=30.0, out=stack[1])
    errs["ad (build_cost_volume)"] = _compare(
        "K8 into a slice", stack[1], cuda_cost.cost_volume_plain(
            vt, ut, lo, hi, gmin=-DMAX, L=L, mode="ad", tmax=90.0))
    if not bool((stack[0] == -1.0).all()):
        raise AssertionError("K8 wrote outside its slice of the stack")
    print(f"[11] K8 == plain (build_cost_volume's composition) at {H}x{W}, "
          f"L={L} in every family: NaN pixels, windows the truth +- 8 with "
          f"every 7th empty, census on {CENSUS_WORDS} random words a pixel, "
          f"and into a slice of a stack: {TOL}, max abs err {errs}",
          flush=True)
    return max(errs.values())


def _dense_stage(ut, vt, cfg):
    """full_16dir's `_dense_cc`: both sides' K8 volumes of (ut, vt)."""
    from mgm_tpu_torch.ops import fused

    return fused._dense_cc(ut[None], vt[None], sides=(
        (cfg.dmin, 0, cfg.dmax - cfg.dmin), (-cfg.dmax, 0,
                                             cfg.dmax - cfg.dmin)),
        L=cfg.dmax - cfg.dmin + 1, mode=cfg.distance,
        trunc_dist=cfg.trunc_dist)


def _k2k8_launch_worker() -> int:
    """Phase 11's device-kernel counts, in a process of its own (late in
    a long one torch.profiler loses kernels: phase 24): LAUNCH_REPS K2
    calls at cfg1 (no taps) and at cfg2 (taps) on K1's volumes, and
    LAUNCH_REPS runs of full_16dir's `_dense_cc` (after a warm run of
    each); prints them as JSON."""
    sys.path.insert(0, REPO)
    import torch
    from mgm_tpu_torch.models import get_preset
    from mgm_tpu_torch.ops import cuda_fused
    from mgm_tpu_torch.synthetic import synthetic_pair

    u, v, _ = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    rec = {}
    for tag, cfg, taps in (
            ("cfg1", _fast_ad(), False),
            ("cfg2", get_preset("census_tl", dmin=DMIN, dmax=DMAX,
                                test_lr=True), True)):
        inp = _k1_inputs(cfg, u, v)
        vol, ns = _planes(cuda_fused.fused_wavefront, cfg, inp)

        def k2():
            return cuda_fused.wta(vol, nspaces=ns, sides=inp["sides"],
                                  want_taps=taps)

        k2()
        n = cuda_fused.wta.launches
        device = _device_launches(k2, K2_KERNEL, LAUNCH_REPS)
        rec[tag] = {"device": device, "calls": cuda_fused.wta.launches - n}
        del vol
    ut, vt = (torch.from_numpy(a).cuda().float() for a in (u, v))
    cfg = _fast_ad(ndir=16)
    _dense_stage(ut, vt, cfg)
    rec["dense_cc"] = _device_kernels(lambda: _dense_stage(ut, vt, cfg),
                                      LAUNCH_REPS)
    print(json.dumps(rec), flush=True)
    return 0


def _k2k8_launches() -> None:
    """Phase 11's device-kernel counts (_k2k8_launch_worker): K2 one
    device launch a call at cfg1 and cfg2; full_16dir's `_dense_cc` two
    K8 launches a run and no other kernel over a volume (every other
    launch under a tenth of a K8 launch: a pass over a volume takes at
    least its write, 0.063 ms; the profiler's pads and the windows'
    fills take microseconds)."""
    rec = _launches_process("--k2k8-launches")
    kern = rec["dense_cc"]
    n8 = sum(c for k, (c, _) in kern.items() if K8_KERNEL in k)
    k8_dev = sum(t for k, (_, t) in kern.items() if K8_KERNEL in k)
    others = {k: c for k, c in kern.items() if K8_KERNEL not in k}
    print(f"[11] device kernels by torch.profiler in a process of its own, "
          f"{LAUNCH_REPS} runs: K2 at cfg1 {rec['cfg1']}, at cfg2 + taps "
          f"{rec['cfg2']} (device launches, wrapper calls); full_16dir's "
          f"_dense_cc: {n8} K8 launches, {k8_dev:.4f} ms, the other "
          f"kernels (launches, ms) {others}", flush=True)
    for tag in ("cfg1", "cfg2"):
        if not rec[tag]["device"] == rec[tag]["calls"] == LAUNCH_REPS:
            raise AssertionError(f"K2 at {tag}: {rec[tag]}")
    if n8 != 2 * LAUNCH_REPS or any(t / c > 0.1 * k8_dev / n8
                                    for c, t in others.values()):
        raise AssertionError(f"_dense_cc ran {n8} K8 launches in "
                             f"{LAUNCH_REPS} runs and {others}")


def _k8_timing(u, v, card):
    """K8 at full_16dir's two sides (ad, 3 channels, the full band): the
    two launches' device time, the `_dense_cc` stage's, the plain
    version's time and the bound, after holding both sides of each
    bitwise against the plain version.  Returns ((ms, plain_ms,
    library_ms, (bound_ms, bound_by)), max abs err)."""
    import torch
    from mgm_tpu_torch.ops import cuda_cost

    dev = torch.device("cuda")
    ut, vt = (torch.from_numpy(a).to(dev).float() for a in (u, v))
    cfg = _fast_ad(ndir=16)
    lo = torch.zeros((H, W), dtype=torch.int32, device=dev)
    hi = torch.full((H, W), L - 1, dtype=torch.int32, device=dev)
    out = torch.empty((2, H, W, L), device=dev)
    tmax = cfg.trunc_dist * 3

    def k8(fn, **o):
        return lambda: (fn(ut, vt, lo, hi, gmin=DMIN, L=L, mode="ad",
                           tmax=tmax, **{k: t[0] for k, t in o.items()}),
                        fn(vt, ut, lo, hi, gmin=-DMAX, L=L, mode="ad",
                           tmax=tmax, **{k: t[1] for k, t in o.items()}))

    def stage():
        return _dense_stage(ut, vt, cfg)

    # the timed inputs first held against the plain version: both sides
    # of the kernel's own call and of the `_dense_cc` stage
    want = k8(cuda_cost.cost_volume_plain)()
    got = k8(cuda_cost.cost_volume, out=out)() + tuple(stage())
    err = max(_compare(f"K8 full band, side {i % 2}", g, want[i % 2])
              for i, g in enumerate(got))
    del want, got
    print(f"[11] K8 == plain on the timed inputs (full_16dir's two sides, "
          f"the full band, the kernel's call and the _dense_cc stage): "
          f"{TOL}, max abs err {err}", flush=True)
    ms = _event_ms(k8(cuda_cost.cost_volume, out=out), 10)
    stage_ms = _event_ms(stage, 10)
    plain = _event_ms(k8(cuda_cost.cost_volume_plain), 2)
    # both sides: the (H, W, L) volume written once, both images and
    # both windows read once; per cell 3 channels of subtract, abs and
    # add and the minimum with tmax
    bound = _bound(2 * (H * W * L + 2 * H * W * 3 + 2 * H * W) * 4,
                   2 * H * W * L * 10)
    print(f"[11] pointwise_volume (K8, the finished volume): {ms:.4f} ms "
          f"for full_16dir's two sides, the _dense_cc stage {stage_ms:.4f} "
          f"ms, plain {plain:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}):"
          f" {bound[0] / ms:.1%} of it ({H}x{W}x3, L={L}) on {card}",
          flush=True)
    # no single PyTorch call computes a shifted-window distance volume
    return (ms, plain, None, bound), err


def _band_case(case, dev):
    """One K5-on-a-band case's inputs on `dev`: (mesh, bands, the
    unsharded volume and windows, the scan's keywords)."""
    import torch
    from mgm_tpu_torch.parallel import make_mesh
    from mgm_tpu_torch.parallel.halo import band_volumes, cutter

    label, (N, Hs, Ws, Ls), n, block, kw = case
    rng = np.random.default_rng(Hs * Ls + n)
    cc = rng.uniform(0, 50, (N, Hs, Ws, Ls)).astype(np.float32)
    lo = rng.integers(0, max(1, Ls // 3), (N, Hs, Ws)).astype(np.int32)
    hi = (lo + Ls // 2).astype(np.int32)
    if kw.get("fh_restrict"):
        inw = (np.arange(Ls) >= lo[..., None]) & (np.arange(Ls)
                                                  <= hi[..., None])
        cc = np.where(inw, cc, np.inf).astype(np.float32)
    w8 = np.where(rng.random((N, Hs, Ws, 8)) < 0.5, 0.25, 1.0).astype(
        np.float32)
    t = {k: torch.from_numpy(a).to(dev)
         for k, a in dict(cc=cc, w8=w8, lo=lo, hi=hi).items()}
    side = dict(w8=t["w8"] if kw.get("use_weights") else None)
    if kw.get("fh_restrict"):
        side.update(lo=t["lo"], hi=t["hi"])
    mesh = make_mesh(devices=[dev] * n)
    bands = band_volumes(mesh, Hs, Ws, cutter(t["cc"]), **side)
    return mesh, bands, t["cc"], side, dict(kw, p1=24.0, p2=96.0)


def _band_check(phase, cases, errs, runs, jobs=None):
    """K5 on a band (the sharded dense recursion, parallel/halo.py) over
    in-process ranks on the card against its plain version (the same
    recursion through wavefront_band_plain) and against the unsharded
    K5, bitwise, in each of `runs` runs; returns each case's (plain
    time, the kernel's time) in ms.  With `jobs`: queues the plain runs
    (_plain) and checks nothing."""
    import torch
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf
    from mgm_tpu_torch.parallel.halo import aggregate_bands

    dev = torch.device("cuda")
    times = []
    for case in cases:
        label, (N, Hs, Ws, Ls), n, block, _ = case

        def sharded(mesh, bands, kw, kernel=None, Hs=Hs, Ws=Ws, block=block):
            return mesh.gather_rows(aggregate_bands(
                mesh, Hs, Ws, bands, block=block, kernel=kernel, **kw), Hs)

        def plain(case=case, sharded=sharded):
            mesh, bands, _, _, kw = _band_case(case, dev)
            return _event_once(lambda: sharded(mesh, bands, kw,
                                               wf.wavefront_band_plain))

        if jobs is not None:
            _plain(("K5-band", label), plain, jobs)
            continue
        mesh, bands, cc, side, kw = _band_case(case, dev)
        t, want, ahead = _plain(("K5-band", label), plain)
        one = agg.aggregate(cc, side.get("w8"), side.get("lo"),
                            side.get("hi"), **kw)
        err = 0.0
        for r in range(runs):
            got = sharded(mesh, bands, kw)
            err = max(err, _compare(f"K5-band {label} run {r}", got, want))
            _compare(f"K5-band {label} run {r} against K5", got, one)
            del got
        errs["wavefront_band"] = max(errs["wavefront_band"], err)
        kt = _event_ms(lambda: sharded(mesh, bands, kw), 3)
        times.append((t, kt))
        rows = [mesh.rows(Hs, k) for k in range(n)]
        print(f"[{phase}] K5-band == plain in each of {runs} runs, over {n} "
              f"ranks of the card (row bands {rows}, blocks of {block} "
              f"fronts), {label}: {N}x{Hs}x{Ws}, L={Ls}: {TOL}, max abs err "
              f"{err}; == the unsharded K5 (aggregate); {kt:.3f} ms, plain "
              f"{t:.1f} ms{_while_built(ahead)}", flush=True)
        del want, one, bands
        torch.cuda.empty_cache()
    return times


def _ncc_bands(u, v, ncc, mesh):
    """ncc_mesh2's band volumes as compute_disparity builds them
    (halo.pair_bands on the prepped images), and the whole volumes."""
    import torch
    from mgm_tpu_torch import stereo
    from mgm_tpu_torch.ops.cost import build_cost_volume
    from mgm_tpu_torch.parallel.halo import pair_bands

    ut, vt = (stereo._preprocess(stereo._scrub(a, "cuda"), ncc)
              for a in (u, v))
    lo = torch.stack([torch.full((H, W), 0, dtype=torch.int32,
                                 device="cuda")] * 2)
    hi = lo + L - 1
    kw = dict(distance="ncc", L=L, trunc_dist=ncc.trunc_dist,
              ncc_win=ncc.census_ncc_win)
    bands = pair_bands(mesh, ut, vt, lo, hi, (DMIN, -DMAX),
                       pids=range(ncc.ndir), **kw)
    whole = torch.stack([build_cost_volume(a, b, lo[0], hi[0], g, **kw)
                         for a, b, g in ((ut, vt, DMIN), (vt, ut, -DMAX))])
    return bands, whole


def _band_bound(ncc, n):
    """(bytes, float32 operations) of the sharded NCC recursion: K5's
    (each pass's costs read, its output and minima written, about 20
    operations a cell) plus the halo tracks, each sub-launch's band edge
    row (L values and the minimum a front, each plane) written by n - 1
    ranks and read by their neighbours."""
    from mgm_tpu_torch.ops import aggregate as agg

    nbytes = ops = 0
    for g in agg._pass_groups(ncc.ndir, ncc.mgm):
        plan = agg.group_plan(g, H, W, ncc.mgm)
        planes = 2 * len(g)
        cells = planes * H * W * L
        nbytes += 2 * cells * 4 + planes * H * W * 4
        ops += cells * 20
        T = plan.C + plan.slope * (plan.R - 1)
        nbytes += 2 * (n - 1) * T * planes * (L + 1) * 4
    return nbytes, ops


def _stream_peaks(fn, names: dict):
    """The peak bytes live on each stream during fn(), from the caching
    allocator's trace of its allocations and frees (an allocation
    belongs to the stream it was made on): ({names[stream] or "other":
    bytes}, the peak of their sum)."""
    import torch

    torch.cuda.synchronize()
    rec = dict(context=None, stacks="python", max_entries=10**7)
    try:   # a fresh trace (clear_history is newer than the tracer)
        torch.cuda.memory._record_memory_history(**rec, clear_history=True)
    except TypeError:
        torch.cuda.memory._record_memory_history(**rec)
    try:
        fn()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    owner, live, peak = {}, {}, {}
    total = top = 0
    for e in trace:
        if e["action"] == "alloc":
            who, size = names.get(e.get("stream"), "other"), e["size"]
            owner[e["addr"]] = (who, size)
        elif e["action"] == "free_completed" and e["addr"] in owner:
            who, size = owner.pop(e["addr"])
            size = -size
        else:
            continue
        live[who] = live.get(who, 0) + size
        peak[who] = max(peak.get(who, 0), live[who])
        total += size
        top = max(top, total)
    return peak, top


def _k5b_launch_worker() -> int:
    """Phase 29's count of K5-band's device kernels, in a process of its
    own (late in a long process torch.profiler loses kernels): one
    ncc_mesh2 run (after a warm one) under torch.profiler; prints its
    K5-band kernels, their device ms, the wrapper's calls, the run's
    host wall and the card's busy share of it, then each rank's peak
    memory in one more run and the unsharded run's (_stream_peaks), as
    JSON."""
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mgm_tpu_torch import compute_disparity
    from mgm_tpu_torch.models import get_preset
    from mgm_tpu_torch.ops import wavefront as wf
    from mgm_tpu_torch.parallel import make_mesh
    from mgm_tpu_torch.synthetic import synthetic_pair

    u, v, _ = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    ncc = get_preset("ncc", dmin=DMIN, dmax=DMAX)
    mesh = make_mesh(devices=["cuda:0"] * 2)

    def run():
        return compute_disparity(u, v, ncc, mesh=mesh,
                                 outputs=("disp", "cost"))

    run()
    torch.cuda.synchronize()
    wf.wavefront_band.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b, _ in spans:   # the union of the device's kernel intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    band = [(a, b) for a, b, n in spans if K5B_KERNEL in n]
    calls = wf.wavefront_band.launches
    # each rank's peak memory (one-card emulation: the card's peak is
    # every rank's together), beside the unsharded run's, traced alike
    ranks = {mesh.stream(k).cuda_stream: f"rank {k}" for k in range(2)}
    sharded, both = _stream_peaks(lambda: compute_disparity(
        u, v, ncc, mesh=mesh), ranks)
    _, one = _stream_peaks(lambda: compute_disparity(
        u, v, ncc, device="cuda"), {})
    print(json.dumps({"calls": calls, "device": len(band),
                      "device_ms": sum(b - a for a, b in band) / 1e3,
                      "wall_ms": wall * 1e3, "busy": busy / 1e3 / (wall * 1e3),
                      "peak_gib": {k: b / 2**30 for k, b in sharded.items()},
                      "peak_sum_gib": both / 2**30,
                      "unsharded_peak_gib": one / 2**30}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist-worker"]:
        return _dist_worker(int(argv[1]), 2, argv[2], argv[3])
    if argv[:1] == ["--k4-launches"]:
        return _k4_launch_worker()
    if argv[:1] == ["--k2k8-launches"]:
        return _k2k8_launch_worker()
    if argv[:1] == ["--k5b-launches"]:
        return _k5b_launch_worker()
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
    from mgm_tpu_torch.ops import _build, cuda_fused, fused
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf
    from mgm_tpu_torch.ops.cost import build_cost_volume
    from mgm_tpu_torch.parallel.fused_shard import BLOCK
    from mgm_tpu_torch.synthetic import synthetic_mrf, synthetic_pair

    t_start = time.perf_counter()
    # ---- 1. device and build ------------------------------------------
    card = _device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} visible",
          flush=True)
    # the kernel-against-plain checks' cases and inputs: their plain runs
    # go ahead while the kernels build (_build_ahead)
    cfg = _fast_ad()
    cfg2 = get_preset("census_tl", dmin=DMIN, dmax=DMAX, test_lr=True)
    # cfg4: AD on 3 sobel-x channels truncated at 63*3, FH
    cfg4 = get_preset("sobelx_tl", dmin=DMIN, dmax=DMAX, test_lr=True)
    sat = get_preset("satellite", test_lr=True)
    pair = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    u, v, d_true = pair
    strip = synthetic_pair(STRIP, W, DMIN, DMAX, seed=1)[:2]
    k4_strip = synthetic_pair(STRIP, K4_STRIP_W, DMIN, DMAX, seed=1)[:2]
    pp_strip = synthetic_pair(STRIP, W, DMIN, DMAX, seed=19)
    k1_checks = {
        "2-3": ((("cfg1", cfg, None),
                 ("fast_ad", _fast_ad(ndir=2, mgm=4), None)), strip),
        "5": ((("cfg1", cfg, None),), (u, v)),
        "10": ((("fast_ad V group", _fast_ad(ndir=8), 1),
                ("fast_ad parity group", _fast_ad(ndir=8, mgm=4), 1)),
               synthetic_pair(STRIP, W, DMIN, DMAX, seed=2)[:2]),
        "14": ((("full_16dir", _fast_ad(ndir=16), None),
                ("cfg1_tsgm4", _fast_ad(mgm=4), None)), strip),
        # cfg4 on the strip: at the full shape its plain run alone takes
        # about 46 s, and cfg2 already holds the full shape's groups
        "15": ((("cfg4", cfg4, None),), strip),
        "16": ((("bt", get_preset("bt", dmin=DMIN, dmax=DMAX,
                                  test_lr=True), None),
                ("cfg2 with weights (aP2 0.5)", cfg2.replace(a_p2=0.5),
                 None),
                ("fast_ad ndir 8 with weights (aP2 0.5)",
                 _fast_ad(ndir=8, a_p2=0.5), None)), strip)}
    pp_cases = (
        ("fast_ad TSGM 2", _fast_ad()),
        ("census_tl", get_preset("census_tl", dmin=DMIN, dmax=DMAX,
                                 test_lr=True)),
        ("FH TSGM 2 unweighted", _fast_ad(use_trunc_linear=True)),
        ("weighted FH TSGM 2 (aP2 0.5)",
         _fast_ad(use_trunc_linear=True, a_p2=0.5)))
    # (the first case's plain time is K4's record: it runs after the build)
    k4_cases = (
        ("cfg1 A/B stagger, strip", cfg, k4_strip, 2, None, None, True),
        ("cfg1 A/B stagger, full shape", cfg, (u, v), 2, None, None, False),
        ("cfg2 V group (census, FH, lockstep aprons), strip", cfg2,
         k4_strip, 2, 1, None, True),
        ("cfg2 V group, full shape", cfg2, (u, v), 2, 1, None, False),
        ("cfg1_tsgm4 PB group (lockstep aprons), strip", _fast_ad(mgm=4),
         k4_strip, 2, 1, None, True),
        ("cfg1_tsgm4 PB group, full shape", _fast_ad(mgm=4), (u, v), 2, 1,
         None, False),
        ("cfg1, ragged rows", cfg,
         synthetic_pair(61, K4_STRIP_W, DMIN, DMAX, seed=5)[:2], 3, None, 4,
         True))
    # (the plain recursion steps a front at a time over both the row and
    # the column bands: a 700-wide strip's column bands are 700 canonical
    # rows deep, 22-72 s a case on the H100; BAND_STRIP keeps each case
    # a few seconds, 5 and more blocks a band; the first case's plain
    # time is K5-band's record: it runs after the build)
    band_cases = (
        ("every group kind (ndir 16, TSGM 2: axis slope 1, diagonal slope "
         "2, knight; both flow signs, row and column bands)",
         (2,) + BAND_STRIP + (L,), 2, BLOCK, dict(ndir=16, mgm=2)),
        ("weighted FH (mgm_o VTYPE 1: ndir 8, TSGM 2)",
         (1,) + BAND_STRIP + (L,), 2, BLOCK,
         dict(ndir=8, mgm=2, use_fh=True, use_weights=True)),
        ("weighted FH restricted to windows, TSGM 3, blocks of 4",
         (2, 20, BAND_STRIP[1], L), 3, 4, dict(ndir=8, mgm=3, use_fh=True,
                                              use_weights=True,
                                              fh_restrict=True)),
        ("9 rows over 4 ranks (3, 3, 3 and none), ndir 16 TSGM 4",
         (2, 9, BAND_STRIP[1], L), 4, BLOCK, dict(ndir=16, mgm=4)))
    jobs = []
    for phase, (cases, (cu_, cv_)) in k1_checks.items():
        _fused_check(phase, cases, None, cu_, cv_, jobs=jobs)
    for i in range(len(DENSE_CASES)):
        _dense_strip(i, jobs)
    _pp_check("19", pp_cases, None, pp_strip, jobs)
    _plain(("K1 batch", 8), lambda: _batch_plain(sat, 8), jobs)
    _k4_check("24", k4_cases[1:], None, RACE_RUNS, jobs)
    _band_check("28", band_cases[1:], None, RACE_RUNS, jobs)
    lib, secs, done = _build_ahead(jobs)
    print(f"[1] kernels built in {secs:.1f} s: {lib} (at a lower "
          f"priority; meanwhile {done} of {len(jobs)} plain runs of the "
          f"checks were made)")
    print((lib.parent / "build.log").read_text().strip(), flush=True)

    # ---- 2./3. K1 and K2 against their plain versions ----------------
    _stamp("2", t_start)
    errs = {n: 0.0 for n in tuple(_kernels()) + ABSORBED}
    _fused_check("2-3", k1_checks["2-3"][0], errs, *k1_checks["2-3"][1])

    # ---- 4. cfg1 end to end -------------------------------------------
    _stamp("4", t_start)
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

    # ---- 5. K1 and K2 at cfg1's full shape; K2's time at cfg1 ---------
    _stamp("5", t_start)
    # (phase 15 times K1 and K2 + taps at cfg2: K1's record)
    _fused_check("5", k1_checks["5"][0], errs, u, v, RACE_RUNS)
    ms, plain_ms, library_ms, bounds = {}, {}, {}, {}
    inp = _k1_inputs(cfg, u, v)
    vol, ns = _planes(cuda_fused.fused_wavefront, cfg, inp)
    (ms["wta"], plain_ms["wta"], library_ms["wta"],
     bounds["wta"]) = _k2_timing("5", "cfg1", vol, ns, inp["sides"], False,
                                 card)
    del vol, inp

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
    _stamp("6", t_start)
    for i, case in enumerate(DENSE_CASES):
        e, plan = _dense_strip(i)
        errs["wavefront_scan"] = max(errs["wavefront_scan"], e)
        print(f"[6] K5 == plain (canonicalise, skew, fronts, unskew, "
              f"un-canonicalise) at {STRIP}x{W}, L={L}, 2 problems, "
              f"{case[0]} ({len(plan.specs)} passes {plan.R}x{plan.C} "
              f"canonical, slope {plan.slope}): {TOL}, max abs err {e}",
              flush=True)
    torch.cuda.empty_cache()

    # ---- 7. mgm_o at full width ---------------------------------------
    _stamp("7", t_start)
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
            tag = f"mgm_o_vtype{vtype}"
            by_path["wavefront_scan"][tag] = got["wavefront_scan"]
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
            _dense_device("7", f"mgm_o VTYPE {vtype}",
                          lambda: mrf_cli.main(argv), got["wavefront_scan"],
                          len(agg._pass_groups(8, 2)))
            cu, cw = unary[:64, :96], w8[:64, :96]
            a = solve_mrf(cu, 8, 8.0, 32.0, 2, vtype, cw, device="cuda")
            b = solve_mrf(cu, 8, 8.0, 32.0, 2, vtype, cw, device="cpu")
            _compare(f"mgm_o crop VTYPE {vtype}", torch.from_numpy(a),
                     torch.from_numpy(b))
            print(f"[7] mgm_o on a {a.shape} crop, VTYPE {vtype}: CUDA == "
                  f"CPU plain ({TOL})", flush=True)
    del unary, w8

    # ---- 8. the ncc preset at cfg1 geometry ---------------------------
    _stamp("8", t_start)
    ncc = get_preset("ncc", dmin=DMIN, dmax=DMAX)
    _zero(DENSE_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    out = compute_disparity(u, v, ncc, device="cuda")
    got = _counts(DENSE_KERNELS)
    if min(got.values()) < 1:
        raise AssertionError(f"NCC bypassed a kernel: {got}")
    by_path["wavefront_scan"]["ncc"] = got["wavefront_scan"]
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
    _dense_device("8", "ncc", lambda: compute_disparity(
        u, v, ncc, device="cuda"), got["wavefront_scan"],
        len(agg._pass_groups(ncc.ndir, ncc.mgm)))

    # ---- 9. K5 at the largest NCC pass group ---------------------------
    _stamp("9", t_start)
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
    del ut, vt
    groups = agg._pass_groups(ncc.ndir, ncc.mgm)
    plans = [agg.group_plan(g, H, W, ncc.mgm) for g in groups]
    big = max(range(len(plans)), key=lambda i: plans[i].R * (
        plans[i].C + plans[i].slope * (plans[i].R - 1)))
    plan = plans[big]
    s = plan.slope
    R, C = plan.R, plan.C
    A = len(plan.specs) * cc.shape[0]
    T = C + s * (R - 1)
    kw = agg.scan_kwargs(plan, p1=ncc.p1 * 3, p2=ncc.p2 * 3, mgm=ncc.mgm,
                         use_fh=False, use_weights=False, fh_restrict=False)
    # K5 against its plain version on the same inputs, at the shapes the
    # NCC run gives it, then timed
    where = f"at the NCC run's largest group ({A}x{R}x{C}, L={L})"
    plain_ms["wavefront_scan"], ref = _event_once(
        lambda: wf.wavefront_scan_plain(cc, **kw))
    e9 = 0.0
    for run in range(RACE_RUNS):   # a missing wait shows as a race
        got = wf.wavefront_scan(cc, **kw)
        e9 = max(e9, _compare(f"K5 {where}, run {run}", got, ref))
        del got
    del ref
    errs["wavefront_scan"] = max(errs["wavefront_scan"], e9)
    ms["wavefront_scan"] = _event_ms(lambda: wf.wavefront_scan(cc, **kw), 3)
    library_ms["wavefront_scan"] = None
    print(f"[9] K5 == plain {where}: {TOL} in each of {RACE_RUNS} runs, max "
          f"abs err {e9}", flush=True)
    cells = A * R * C * L
    # one read of each pass's costs and one write of its output, plus the
    # minima it writes a pixel.  Per cell: 2 messages of ~8 operations,
    # the halving sum, the add and the minimum
    bounds["wavefront_scan"] = _bound(2 * cells * 4 + A * R * C * 4,
                                      cells * 20)
    # the TPU's skew and unskew, absorbed: their plain versions and one
    # library copy each at this group's shapes, on its canonical costs
    x = wf.canonical_plain(cc, wf._pixels(plan.maps, R, C, dev), R, C)
    del cc
    inf = float("inf")
    sk = wf.skew_plain(x, inf, s)
    plain_ms["skew"] = _event_ms(lambda: wf.skew_plain(x, inf, s), 2)
    lib_out = torch.full_like(sk, inf)
    view = lib_out.as_strided((A, R, C, L), (R * T * L, (T + s) * L, L, 1))
    library_ms["skew"] = _event_ms(lambda: view.copy_(x), 5)
    _same_bits("the skew's library copy", lib_out, sk)
    del lib_out, view
    plain_ms["unskew"] = _event_ms(lambda: wf.unskew_plain(sk, C, s), 2)
    lib_out = torch.empty_like(x)
    view = sk.as_strided((A, R, C, L), (R * T * L, (T + s) * L, L, 1))
    library_ms["unskew"] = _event_ms(lambda: lib_out.copy_(view), 5)
    _same_bits("the unskew's library copy", lib_out, x)
    del lib_out, view, sk, x
    for n in ABSORBED:   # nothing runs or moves for them on any path
        ms[n], bounds[n] = None, (None, None)
    print(f"[9] wavefront_scan: {ms['wavefront_scan']:.3f} ms, plain "
          f"{plain_ms['wavefront_scan']:.3f} ms, bound "
          f"{bounds['wavefront_scan'][0]:.3f} ms "
          f"({bounds['wavefront_scan'][1]})", flush=True)
    for n in ABSORBED:
        print(f"[9] {n} (absorbed into K5): plain {plain_ms[n]:.3f} ms, "
              f"library {library_ms[n]:.3f} ms", flush=True)
    print(f"[9] at the NCC run's largest group: {A} planes, {R}x{C} "
          f"canonical, slope {s}, {T} fronts, L={L} on {card}", flush=True)
    print(f"[9] K5: {ms['wavefront_scan'] / T * 1e3:.3f} us a front at the "
          f"NCC run's largest group ({T} fronts; 2.233 before the skew went "
          f"into its addressing) on {card}", flush=True)
    torch.cuda.empty_cache()
    # K5 at full_16dir's column knight group (random costs, both sides)
    # and at mgm_o's weighted FH group (VTYPE 1, the planted problem)
    unary, w8, _ = synthetic_mrf(H, W, L, seed=0)
    for what, ndir, fh, ccv, w8v in (
            ("full_16dir's column knight group", 16, False,
             torch.from_numpy(np.random.default_rng(9).uniform(
                 0, 50, (2, H, W, L)).astype(np.float32)).to(dev), None),
            ("mgm_o's weighted FH group (VTYPE 1)", 8, True,
             torch.from_numpy(unary).to(dev)[None],
             torch.from_numpy(w8).to(dev)[None])):
        pids = [g for g in agg._pass_groups(ndir, 2)
                if agg.group_plan(g, H, W, 2).R == W][-1]
        plan = agg.group_plan(pids, H, W, 2)
        kw = agg.scan_kwargs(plan, p1=8.0 if fh else 24.0,
                             p2=32.0 if fh else 96.0, mgm=2, use_fh=fh,
                             use_weights=fh, fh_restrict=False)
        ref = wf.wavefront_scan_plain(ccv, w8v, **kw)
        got = wf.wavefront_scan(ccv, w8v, **kw)
        e = _compare(f"K5 at {what}", got, ref)
        kms = _event_ms(lambda: wf.wavefront_scan(ccv, w8v, **kw), 1)
        errs["wavefront_scan"] = max(errs["wavefront_scan"], e)
        Tk = plan.C + plan.slope * (plan.R - 1)
        print(f"[9] K5 == plain at {what}: {len(plan.specs)} passes x "
              f"{ccv.shape[0]} images of {plan.R}x{plan.C} canonical "
              f"(knight {plan.knight}, slope {plan.slope}): {TOL}, max abs "
              f"err {e}; {kms:.3f} ms = {kms / Tk * 1e3:.3f} us a front on "
              f"{card}", flush=True)
        del ccv, w8v, ref, got
        torch.cuda.empty_cache()
    del unary, w8

    # ---- 10. K1 and K2 in the V and packed-parity spaces -------------
    _stamp("10", t_start)
    _fused_check("10", k1_checks["10"][0], errs, *k1_checks["10"][1])

    # ---- 11. K8 against its plain version at full width -------------
    _stamp("11", t_start)
    k8e = _k8_check(u, v, d_true, dev)
    k8r, k8t = _k8_timing(u, v, card)
    errs["pointwise_volume"] = max(k8e, k8t)
    for d, part in zip((ms, plain_ms, library_ms, bounds), k8r):
        d["pointwise_volume"] = part
    _k2k8_launches()

    # ---- 12./13. full_16dir and cfg1_tsgm4 end to end ----------------
    _stamp("12", t_start)
    rows = {"full_16dir": ("12", _fast_ad(ndir=16),
                           ("fused_wavefront",) + DENSE_KERNELS
                           + ("pointwise_volume",)),
            "cfg1_tsgm4": ("13", _fast_ad(mgm=4), FUSED_KERNELS)}
    for tag, (phase, rcfg, names) in rows.items():
        got = _stereo_path(phase, tag, rcfg, pair, names, card, REPS)
        for n in got:
            by_path[n][tag] = got[n]
        if "wavefront_scan" in got:
            _dense_path_device(phase, tag, rcfg, pair, got)
        torch.cuda.empty_cache()

    # ---- 14. K1 and K2 for the new rows' groups; K1 per front ---------
    _stamp("14", t_start)
    _fused_check("14", k1_checks["14"][0], errs, *strip)
    torch.cuda.empty_cache()
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

    # ---- 15. K1 and K2 (+ taps) at cfg2's full shape, cfg4's strip --
    _stamp("15", t_start)
    # cfg2: census 3x3 (one word a pixel), FH, ndir 8, TSGM 3: A/B at
    # slope 2 and V; these are the kernels' record's times and bounds
    # (K1's plain time the strip's, beside K1's own there).
    k1k2 = _fused_timing("15", "cfg2", cfg2, u, v, strip, errs, card)
    for d, part in zip((ms, plain_ms, library_ms, bounds), k1k2):
        d["fused_wavefront"] = part["fused_wavefront"]
    strip_ms = {"fused_wavefront": k1k2[4]}
    k2_cfg2 = {"ms": k1k2[0]["wta"], "plain_ms": k1k2[1]["wta"],
               "bound_ms": k1k2[3]["wta"][0], "bound_by": k1k2[3]["wta"][1],
               "library_ms": k1k2[2]["wta"]}
    torch.cuda.empty_cache()
    _fused_check("15", k1_checks["15"][0], errs, *strip)
    torch.cuda.empty_cache()

    # ---- 16. K1 and K2 with BT costs and with edge weights -----------
    _stamp("16", t_start)
    _fused_check("16", k1_checks["16"][0], errs, *strip)

    # ---- 17. cfg2 and cfg4 end to end ---------------------------------
    _stamp("17", t_start)
    rows = {"cfg2": ("17", cfg2),
            "cfg4": ("17", cfg4)}
    for tag, (phase, rcfg) in rows.items():
        got = _stereo_path(phase, tag, rcfg, pair, FUSED_KERNELS, card, REPS,
                           tol=0.5)
        for n in got:
            by_path[n][tag] = got[n]
        torch.cuda.empty_cache()

    # ---- 18. the other presets: CUDA == CPU on the crop ---------------
    _stamp("18", t_start)
    _crop_check("18", "satellite", get_preset("satellite", test_lr=True),
                u, v)
    for name in ("bt", "full_16dir"):
        _crop_check("18", f"{name} preset", get_preset(
            name, dmin=DMIN, dmax=DMAX, test_lr=True), u, v)

    # ---- 19. K1 under per-pixel windows against its plain version --
    _stamp("19", t_start)
    _pp_check("19", pp_cases, errs, pp_strip)
    del pp_strip
    torch.cuda.empty_cache()

    # ---- 20. cfg1_mM: per-pixel -m/-M windows end to end --------------
    _stamp("20", t_start)
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
    _stamp("21", t_start)
    # the label axis grows by 4 * (iterations - 1) on each side
    L_it = L + 2 * 4 * 2
    rows = {"cfg1_iter3": (_fast_ad(iterations=3), FUSED_KERNELS, 0.0),
            "ncc_iter3": (ncc.replace(iterations=3), DENSE_KERNELS, 0.5)}
    for tag, (rcfg, names, tol) in rows.items():
        got = _stereo_path("21", tag, rcfg, pair, names, card, NEW_REPS,
                           tol=tol, L_=L_it)
        for n in got:
            by_path[n][tag] = got[n]
        if "wavefront_scan" in got:
            _dense_path_device("21", tag, rcfg, pair, got)
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
    _stamp("22", t_start)
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
    t, want, ahead = _plain(("K1 batch", 8), lambda: _batch_plain(sat, 8))
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
          f"batch (8 pairs, 16 sides, {ns} spaces, {SAT_H}x{SAT_W}, "
          f"L={L_sat}): {TOL}, max abs err {e1}, plain {t:.1f} ms"
          f"{_while_built(ahead)}; K2 + taps == plain on those planes: max "
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
    _stamp("23", t_start)
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
    _stamp("24", t_start)
    # K4 against its plain version on strips (at the full shape the plain
    # recursion takes 10-20 s a case); at the full shape against K1
    plain_k4 = _k4_check("24", k4_cases, errs, RACE_RUNS)
    kin = _k1_inputs(cfg, *k4_strip)
    strip_ms["fused_block"] = _event_ms(lambda: _k4_planes(
        cuda_fused.fused_block, cfg, kin, 2), 3)
    del kin
    inp = _k1_inputs(cfg, u, v)
    _zero(("fused_block",))
    _k4_planes(cuda_fused.fused_block, cfg, inp, 2)
    blocks = _counts(("fused_block",))["fused_block"]
    # counted in a process of its own: late in this one torch.profiler
    # reported 101-103 of the 124 kernels on the H100, in fresh processes
    # every one
    rec = _launches_process("--k4-launches")
    print(f"[24] K4's device kernel launches in cfg1's sharded recursion "
          f"over 2 ranks, in a process of its own (torch.profiler): "
          f"{rec['device']} (one a block: {rec['calls']} wrapper calls; "
          f"{blocks} here)", flush=True)
    if not rec["device"] == rec["calls"] == blocks:
        raise AssertionError(f"K4 launched {rec['device']} device kernels "
                             f"in {rec['calls']} calls ({blocks} here)")
    ms["fused_block"] = _event_ms(lambda: _k4_planes(
        cuda_fused.fused_block, cfg, inp, 2), 3)
    plain_ms["fused_block"] = plain_k4[0]
    library_ms["fused_block"] = None
    bounds["fused_block"] = _k4_bound(cfg, inp, 2)
    print(f"[24] fused_block: {ms['fused_block']:.3f} ms for cfg1's sharded "
          f"recursion over 2 ranks of one card ({blocks} blocks of "
          f"{BLOCK} steps = {ms['fused_block'] / blocks:.4f} ms a block), "
          f"bound "
          f"{bounds['fused_block'][0]:.3f} ms ({bounds['fused_block'][1]}: "
          f"K1's volume, images and tracks); on the {STRIP}x{K4_STRIP_W} "
          f"strip {strip_ms['fused_block']:.3f} ms, plain "
          f"{plain_ms['fused_block']:.3f} ms on {card}", flush=True)
    del inp
    torch.cuda.empty_cache()

    # ---- 25. the sharded path end to end ------------------------------
    _stamp("25", t_start)
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
    _stamp("26", t_start)
    ref1 = compute_disparity(u, v, cfg, device="cuda")
    by_path["fused_block"]["cfg1_2proc"] = _two_processes(
        "26", "cfg1_2proc", ref1, card)[0]

    # ---- 27. several cards ---------------------------------------------
    _stamp("27", t_start)
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

    # ---- 28. K5 on a band against its plain version -------------------
    _stamp("28", t_start)
    band_times = _band_check("28", band_cases, errs, RACE_RUNS)

    # ---- 29. ncc_mesh2: the dense mesh path at full width ------------
    _stamp("29", t_start)
    got = _mesh_path("29", "ncc_mesh2", ncc, pair, 2, card,
                     names=BAND_KERNELS, absent=DENSE_ABSENT)
    by_path["wavefront_band"]["ncc_mesh2"] = got["wavefront_band"]
    rec = _launches_process("--k5b-launches")
    print(f"[29] K5-band's device kernel launches in one ncc_mesh2 run, in "
          f"a process of its own (torch.profiler): {rec['device']} (one a "
          f"block: {rec['calls']} wrapper calls; {got['wavefront_band']} "
          f"here), their device time {rec['device_ms']:.3f} ms (2 ranks' "
          f"kernels overlap), the run's wall {rec['wall_ms']:.3f} ms, the "
          f"card busy {rec['busy']:.3f} of it; peak memory by the stream "
          f"that allocated it (the caching allocator's trace of one run): "
          f"{ {k: round(b, 3) for k, b in rec['peak_gib'].items()} } GiB "
          f"(\"other\": the current stream's: the images, the gathered "
          f"maps, the post stages), all together {rec['peak_sum_gib']:.3f}"
          f" GiB; the unsharded run {rec['unsharded_peak_gib']:.3f} GiB",
          flush=True)
    if not rec["device"] == rec["calls"] == got["wavefront_band"]:
        raise AssertionError(f"K5-band launched {rec['device']} device "
                             f"kernels in {rec['calls']} calls "
                             f"({got['wavefront_band']} here)")
    from mgm_tpu_torch.parallel import make_mesh
    from mgm_tpu_torch.parallel.halo import aggregate_bands

    mesh2 = make_mesh(devices=["cuda:0"] * 2)
    bands, whole = _ncc_bands(u, v, ncc, mesh2)
    nkw = dict(p1=ncc.p1 * 3, p2=ncc.p2 * 3, ndir=ncc.ndir, mgm=ncc.mgm)
    lsum = mesh2.gather_rows(aggregate_bands(mesh2, H, W, bands, **nkw), H)
    one = agg.aggregate(whole, **nkw)
    errs["wavefront_band"] = max(errs["wavefront_band"], _compare(
        "K5-band at ncc_mesh2's full width against K5", lsum, one))
    del lsum, one
    ms["wavefront_band"] = _event_ms(
        lambda: aggregate_bands(mesh2, H, W, bands, **nkw), 3)
    k5_ncc = _event_ms(lambda: agg.aggregate(whole, **nkw), 3)
    plain_ms["wavefront_band"], strip_ms["wavefront_band"] = band_times[0]
    library_ms["wavefront_band"] = None
    bounds["wavefront_band"] = _bound(*_band_bound(ncc, 2))
    band_bytes = [sum(t.numel() * 4 for side in b.values() if side
                      for t in side if t is not None)
                  for b in bands.values()]
    print(f"[29] wavefront_band (K5 on a band): {ms['wavefront_band']:.3f} ms"
          f" for ncc_mesh2's sharded recursion over 2 ranks of one card "
          f"({got['wavefront_band']} blocks of {BLOCK} fronts), the "
          f"unsharded K5 {k5_ncc:.3f} ms ({ms['wavefront_band'] / k5_ncc:.2f}"
          f" times); == K5 at full width ({TOL}); on the {BAND_STRIP} strip "
          f"of ndir 16 {strip_ms['wavefront_band']:.3f} ms, plain "
          f"{plain_ms['wavefront_band']:.1f} ms; bound "
          f"{bounds['wavefront_band'][0]:.3f} ms "
          f"({bounds['wavefront_band'][1]}: K5's bytes and the halo tracks)"
          f"; each rank's band volumes (row and column bands) "
          f"{[round(b / 2**30, 3) for b in band_bytes]} GiB on {card}",
          flush=True)
    del bands, whole
    torch.cuda.empty_cache()

    # ---- 30. full_16dir_mesh2: K4, K8 and K5 on a band ------------------
    _stamp("30", t_start)
    got = _mesh_path("30", "full_16dir_mesh2", _fast_ad(ndir=16), pair, 2,
                     card, names=("fused_block", "wavefront_band",
                                  "pointwise_volume"),
                     absent=DENSE_ABSENT + ("wta",))
    for k in got:
        by_path[k]["full_16dir_mesh2"] = got[k]
    torch.cuda.empty_cache()

    # ---- 31. mgm_o_mesh2: solve_tiled against solve_mrf ---------------
    _stamp("31", t_start)
    from mgm_tpu_torch.parallel import solve_tiled

    unary, w8, _ = synthetic_mrf(H, W, L, seed=0)
    cu, cw = (torch.from_numpy(a).cuda()[None] for a in (unary, w8))
    for vtype in (0, 1):
        tag = f"mgm_o_mesh2_vtype{vtype}"
        want = solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w8, device="cuda")

        def tiled():
            return solve_tiled(mesh2, cu, cw, p1=8.0, p2=32.0, ndir=8, mgm=2,
                               use_fh=bool(vtype))

        _zero(tuple(_kernels()))
        torch.cuda.reset_peak_memory_stats()
        disp, _ = tiled()
        got = _counts(BAND_KERNELS + ("wavefront_scan",))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if got["wavefront_band"] < 1 or got["wavefront_scan"]:
            raise AssertionError(f"{tag}: launches {got}")
        by_path["wavefront_band"][tag] = got["wavefront_band"]
        _compare(f"{tag} against solve_mrf", disp[0],
                 torch.from_numpy(want))
        tw = _walls(tiled, NEW_REPS)
        sw = _walls(lambda: solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w8,
                                      device="cuda"), NEW_REPS)
        print(f"[31] {tag}: solve_tiled {W}x{H} L={L} NDIR 8 MGM 2 VTYPE "
              f"{vtype} over 2 ranks of one card: labels == solve_mrf on the "
              f"card ({TOL}); launches {got}; peak device memory {peak:.3f} "
              f"GiB (the card's); wall s {tw}, median "
              f"{statistics.median(tw):.4f} s; solve_mrf median "
              f"{statistics.median(sw):.4f} s on {card}", flush=True)
    del unary, w8, cu, cw, mesh2
    torch.cuda.empty_cache()

    # the absorbed kernels no longer exist: 0 launches wherever K5 runs;
    # K5's group checks hold their work
    for n in ABSORBED:
        by_path[n] = {tag: 0 for tag in by_path["wavefront_scan"]}
        errs[n] = errs["wavefront_scan"]
    launches = {n: sum(c.values()) for n, c in by_path.items()}
    print(f"[31] smoke run took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # plain times taken at another shape than the kernel's timed one
    plain_at = {"fused_wavefront": f"cfg2 on a {STRIP}x{W} strip",
                "fused_block": f"cfg1 on a {STRIP}x{K4_STRIP_W} strip, 2 "
                               f"ranks",
                "wavefront_band": f"ndir 16 on a {BAND_STRIP[0]}x"
                                  f"{BAND_STRIP[1]} strip, 2 ranks"}
    src = {"fused_wavefront": ("mgm_tpu_torch/csrc/fused_wavefront.cu",
                               "mgm_tpu/ops/pallas_fused.py:692"),
           "wta": ("mgm_tpu_torch/csrc/wta.cu",
                   "mgm_tpu/ops/pallas_fused.py:158"),
           "fused_block": ("mgm_tpu_torch/csrc/fused_block.cu",
                           "mgm_tpu/ops/pallas_fused.py:375"),
           "wavefront_scan": ("mgm_tpu_torch/csrc/wavefront.cu",
                              "mgm_tpu/ops/pallas_wavefront.py:224"),
           "wavefront_band": ("mgm_tpu_torch/csrc/wavefront_band.cu",
                              "mgm_tpu/ops/pallas_wavefront.py:224"),
           "skew": ("mgm_tpu_torch/csrc/wavefront.cu",
                    "mgm_tpu/ops/pallas_wavefront.py:43"),
           "unskew": ("mgm_tpu_torch/csrc/wavefront.cu",
                      "mgm_tpu/ops/pallas_wavefront.py:93"),
           "pointwise_volume": ("mgm_tpu_torch/csrc/cost.cu",
                                "mgm_tpu/ops/pallas_cost.py:31")}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1], "launches": launches[n],
         "launches_by_path": by_path[n], "max_abs_err": errs[n],
         "ms": ms[n], "plain_ms": plain_ms[n], "bound_ms": bounds[n][0],
         "bound_by": bounds[n][1], "library_ms": library_ms[n],
         **({"absorbed_into": "mgm_tpu_torch/csrc/wavefront.cu"}
            if n in ABSORBED else {}),
         **({"cfg2_taps": k2_cfg2} if n == "wta" else {}),
         **({"plain_at": plain_at[n], "strip_ms": strip_ms[n]}
            if n in plain_at else {}),
         **({"band": {"name": "wavefront_band",
                      "ms": ms["wavefront_band"],
                      "launches": launches["wavefront_band"],
                      "bound_ms": bounds["wavefront_band"][0]}}
            if n == "wavefront_scan" else {})}
        for n in src]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
