#!/usr/bin/env python3
"""Where the time goes on one GPU: the port's ten full-width runs.

    python3 chip_profile.py [--reps N] [--out DIR] [--rows NAME ...]
                            [--repo DIR]

Run from a checkout on a machine with one CUDA card (it builds the
kernels like chip_smoke.py and imports no JAX).  The runs, on seeded
synthetic data at 700x500, L = 151:
  cfg1        compute_disparity, AD, 4 directions, TSGM 2, LR (fused
              K1/K2);
  cfg1_tsgm4  the same at TSGM 4 (K1 in spaces A and PB, K2);
  full_16dir  the same at 16 directions, TSGM 2 (K1 in A/B and V, the
              knight passes through K8 and K6/K5/K7);
  cfg2        the census_tl preset over -120..30 (census words, FH,
              8 directions, TSGM 3: K1 in A/B and V, K2 with the
              subpixel taps, vfit, median);
  cfg4        the sobelx_tl preset (AD, FH, trunc_dist 63, vfit,
              median);
  ncc         compute_disparity with the `ncc` preset, LR (dense
              K6/K5/K7);
  mgm_o       mrf_cli.main on a protocol file, NDIR 8, MGM 2, VTYPE 0;
  cfg1_mM     cfg1 with full-band constant -m/-M images (per-pixel
              windows in K1, the materialised S assembly instead of K2);
  cfg3_b8     compute_disparity_batch on 8 synthetic satellite pairs
              (279x271x1, the satellite preset over -22..19, LR);
  cfg3_scene  runner.tiled_disparity(tile=512, margin=64, batch=5) on an
              8x8 mosaic of one satellite pair (2232x2168);
  cfg1_mesh2  cfg1 row-sharded over 2 ranks on the one card
              (compute_disparity(mesh=...): K4 on each band, K2 a
              band; an emulation of 2 cards, the ranks one after
              another).
For each run it prints
  - the host wall time, median of N plain runs;
  - host stage times: the run's stage functions are wrapped with a
    synchronize before and after (one more run, so each stage owns its
    device work); "rest" is the run's wall minus its stages;
  - under torch.profiler over N runs: the device's busy share (the
    union of kernel and copy intervals over the host wall) and device
    time by kernel name.
With --out DIR the full tables also go to DIR/profile.json; --rows
names the runs to make (default: all); --repo DIR profiles the
mgm_tpu_torch package of another checkout (e.g. the parent commit, to
compare two versions with one script; its kernels build there).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from chip_smoke import (DMAX, DMIN, H, L, SAT_DMAX, SAT_DMIN,  # noqa: E402
                        SAT_H, SAT_W, W, _device_line, _satellite_pairs,
                        _walls)


# K1's device kernels: the cluster launch, or, in a checkout from before
# K1's cluster redesign (--repo), the per-front kernels
K1_KERNELS = ("fused_wavefront_cluster", "sgm_front_kernel", "fh_front_kernel")


class _Stages:
    """Wraps module attributes so each call is timed between two
    synchronizes (a label indented deeper is part of the one above)."""

    def __init__(self):
        self.ms = {}
        self._undo = []

    def wrap(self, mod, attr, name):
        import torch

        fn = getattr(mod, attr)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + (
                time.perf_counter() - t) * 1e3
            return out

        # a wrapper's body counts on its module-level name: the
        # `launches` counter moves to the timed stand-in
        timed.__dict__.update(fn.__dict__)
        setattr(mod, attr, timed)
        self._undo.append((mod, attr, fn))

    def restore(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo = []


def _device_profile(fn, reps):
    """(busy share of the host wall, device-window ms, host wall ms,
    {kernel name: [device ms, calls]}) over `reps` runs of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, d = e.time_range.start, e.time_range.end
        spans.append((s, d))
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (d - s) / 1e3
        rec[1] += 1
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, d in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, d
        else:
            cur_e = max(cur_e, d)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return busy / 1e3 / wall, window, wall, by_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="directory for profile.json")
    ap.add_argument("--rows", nargs="+", help="run only these rows")
    ap.add_argument("--repo", help="checkout whose mgm_tpu_torch to profile")
    args = ap.parse_args(argv)
    if args.repo:
        sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from mgm_tpu_torch import MGMConfig, mrf, mrf_cli, runner, solver, stereo
    from mgm_tpu_torch.ops import post
    from mgm_tpu_torch.models import get_preset
    from mgm_tpu_torch.ops import _build, cuda_fused, fused
    from mgm_tpu_torch.ops import aggregate as agg
    from mgm_tpu_torch.ops import wavefront as wf
    from mgm_tpu_torch.synthetic import synthetic_mrf, synthetic_pair

    _build.build()
    card = _device_line()     # the card's name and power limit
    print(f"profiling {_build.PKG} on {card}")
    u, v, _ = synthetic_pair(H, W, DMIN, DMAX, seed=0)
    cfg1 = MGMConfig(dmin=DMIN, dmax=DMAX, ndir=4, mgm=2, distance="ad",
                     p1=8, p2=32, test_lr=True)
    tsgm4 = cfg1.replace(mgm=4)
    full16 = cfg1.replace(ndir=16)
    ncc = get_preset("ncc", dmin=DMIN, dmax=DMAX)
    cfg2, cfg4 = (get_preset(n, dmin=DMIN, dmax=DMAX, test_lr=True)
                  for n in ("census_tl", "sobelx_tl"))
    sat = get_preset("satellite", test_lr=True)
    L_sat = SAT_DMAX - SAT_DMIN + 1
    us8, vs8, _ = _satellite_pairs(8)
    su, sv, _ = _satellite_pairs(1, seed0=100)
    su, sv = (np.ascontiguousarray(np.tile(a[0], (8, 8, 1)))
              for a in (su, sv))
    win = dict(dmin_img=np.full((H, W), DMIN, np.float32),
               dmax_img=np.full((H, W), DMAX, np.float32))
    tmp = tempfile.TemporaryDirectory()
    f_in = os.path.join(tmp.name, "input.bin")
    f_out = os.path.join(tmp.name, "labeling.bin")
    unary, w8, _ = synthetic_mrf(H, W, L, seed=0)
    mrf_cli.write_problem(f_in, unary, w8)
    del unary, w8

    def _mesh2():
        from mgm_tpu_torch.parallel import make_mesh

        return make_mesh(devices=["cuda:0"] * 2)

    # (name, run, MP*disp per run, stage wraps: (module, attr, label))
    dense = [(agg, "canonical_inputs", "  canonicalise"),
             (wf, "skew", "  K6 skew"), (wf, "wavefront_scan", "  K5 scan"),
             (wf, "unskew", "  K7 unskew")]
    fused_wta = [(stereo, "_scrub", "upload + scrub"),
                 (stereo, "mgm_solve_fused", "fused solve"),
                 (cuda_fused, "fused_wavefront", "  K1 fused wavefront"),
                 (cuda_fused, "wta", "  K2 wta")]
    refined = [(stereo, "_scrub", "upload + scrub"),
               (stereo, "_preprocess", "census / prefilter"),
               (stereo, "mgm_solve_fused", "fused solve"),
               (cuda_fused, "fused_wavefront", "  K1 fused wavefront"),
               (cuda_fused, "wta", "  K2 wta + taps"),
               (stereo, "subpixel_refine_taps", "refine"),
               (post, "median_filter", "median")]
    runs = [
        ("cfg1", lambda: stereo.compute_disparity(u, v, cfg1, device="cuda"),
         2 * H * W * L, fused_wta),
        ("cfg2", lambda: stereo.compute_disparity(u, v, cfg2, device="cuda"),
         2 * H * W * L, refined),
        ("cfg4", lambda: stereo.compute_disparity(u, v, cfg4, device="cuda"),
         2 * H * W * L, refined),
        ("cfg1_tsgm4", lambda: stereo.compute_disparity(u, v, tsgm4,
                                                        device="cuda"),
         2 * H * W * L, fused_wta),
        ("full_16dir", lambda: stereo.compute_disparity(u, v, full16,
                                                        device="cuda"),
         2 * H * W * L,
         [(stereo, "_scrub", "upload + scrub"),
          (stereo, "mgm_solve_fused", "fused solve"),
          (cuda_fused, "fused_wavefront", "  K1 fused wavefront"),
          (fused, "assemble_groups", "  space sum"),
          (fused, "_dense_cc", "  K8 cost volumes"),
          (fused, "aggregate", "  aggregate knight passes")]
         + [(m, a, " " + n) for m, a, n in dense]
         + [(fused, "assemble_swta", "  S assembly + WTA")]),
        ("ncc", lambda: stereo.compute_disparity(u, v, ncc, device="cuda"),
         2 * H * W * L,
         [(stereo, "_scrub", "upload + scrub"),
          (stereo, "build_cost_volume", "NCC volumes"),
          (stereo, "mgm_solve", "mgm_solve"),
          (solver, "aggregate", " aggregate")] + dense
         + [(stereo, "subpixel_refine", "refine")]),
        ("cfg1_mM", lambda: stereo.compute_disparity(u, v, cfg1,
                                                     device="cuda", **win),
         2 * H * W * L,
         [(stereo, "_scrub", "upload + scrub"),
          (stereo, "mgm_solve_fused", "fused solve"),
          (cuda_fused, "fused_wavefront", "  K1 fused wavefront"),
          (fused, "assemble_groups", "  space sum"),
          (fused, "assemble_swta", "  S assembly + WTA")]),
        ("cfg3_b8", lambda: stereo.compute_disparity_batch(
            us8, vs8, sat, device="cuda"), 8 * 2 * SAT_H * SAT_W * L_sat,
         [(stereo, "_scrub", "upload + scrub"),
          (stereo, "_preprocess", "census"),
          (stereo, "mgm_solve_fused", "fused solve"),
          (cuda_fused, "fused_wavefront", "  K1 fused wavefront"),
          (cuda_fused, "wta", "  K2 wta + taps"),
          (stereo, "subpixel_refine_taps", "refine"),
          (post, "median_filter", "median"),
          (stereo, "_leftright", "LR check")]),
        ("cfg3_scene", lambda: runner.tiled_disparity(
            su, sv, sat, tile=512, margin=64, batch=5),
         2 * su.shape[0] * su.shape[1] * L_sat,
         [(runner, "compute_disparity_batch", "batched solves"),
          (stereo, "_scrub", " upload + scrub"),
          (stereo, "_preprocess", " census"),
          (stereo, "mgm_solve_fused", " fused solve"),
          (cuda_fused, "fused_wavefront", "  K1 fused wavefront"),
          (cuda_fused, "wta", "  K2 wta + taps"),
          (post, "median_filter", " median"),
          (stereo, "_leftright", " LR check")]),
        ("cfg1_mesh2", lambda: stereo.compute_disparity(
            u, v, cfg1, mesh=_mesh2()), 2 * H * W * L,
         [(stereo, "_scrub", "upload + scrub"),
          (stereo, "mgm_solve_fused", "fused solve"),
          (cuda_fused, "fused_block", "  K4 fused block"),
          (cuda_fused, "wta", "  K2 wta")]),
        ("mgm_o", lambda: mrf_cli.main([f_in, f_out, "8", "32", "2", "0"]),
         H * W * L,
         [(mrf_cli, "read_problem", "read protocol file"),
          (mrf_cli, "solve_mrf", "solve_mrf"),
          (mrf, "mgm_solve", " mgm_solve"),
          (solver, "aggregate", "  aggregate")]
         + [(m, a, "  " + n) for m, a, n in dense]
         + [(mrf_cli, "write_labels", "write labels")]),
    ]
    report = {"card": card, "reps": args.reps, "runs": {}}
    for name, fn, work, wraps in runs:
        if args.rows and name not in args.rows:
            continue
        fn()   # warm: kernels loaded, allocator primed
        walls = _walls(fn, args.reps)
        med = statistics.median(walls)
        st = _Stages()
        for mod, attr, label in wraps:
            st.wrap(mod, attr, label)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        staged = (time.perf_counter() - t) * 1e3
        st.restore()
        busy, window, pwall, by_name = _device_profile(fn, args.reps)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        report["runs"][name] = {
            "wall_s": walls, "median_s": med,
            "mp_disp_per_s": work / med / 1e6, "staged_ms": staged,
            "stages_ms": st.ms, "busy_share_of_wall": busy,
            "device_window_ms": window, "profiled_wall_ms": pwall,
            "kernels": {k: {"ms": v[0] / args.reps, "calls": v[1] / args.reps}
                        for k, v in top}}
        print(f"== {name}: median {med * 1e3:.3f} ms of {args.reps} runs = "
              f"{work / med / 1e6:.1f} MP*disp/s on {card}")
        print(f"   staged run {staged:.3f} ms:")
        top_level = sum(ms for k, ms in st.ms.items() if not k[0].isspace())
        for _, _, k in wraps:
            if k in st.ms:
                print(f"   {k:<28} {st.ms[k]:9.3f} ms")
        print(f"   {'rest (host, post, fetch)':<28} "
              f"{staged - top_level:9.3f} ms")
        k1 = [(ms, n) for k, (ms, n) in by_name.items()
              if any(c in k for c in K1_KERNELS)]
        k1_ms, k1_n = (sum(x[i] for x in k1) / args.reps for i in (0, 1))
        k4 = sum(ms for k, (ms, _) in by_name.items() if "band_front" in k)
        report["runs"][name]["k1_kernels_ms"] = k1_ms
        report["runs"][name]["k1_launches"] = k1_n
        report["runs"][name]["k4_front_kernels_ms"] = k4 / args.reps
        print(f"   K1's kernels: {k1_ms:.3f} ms of device time a run in "
              f"{k1_n:.0f} launches; K4's front kernels: "
              f"{k4 / args.reps:.3f} ms")
        print(f"   profiler: device busy {busy:.4f} of the host wall "
              f"({pwall / args.reps:.3f} ms a run profiled), device window "
              f"{window / args.reps:.3f} ms a run")
        for k, (ms, calls) in top[:12]:
            print(f"   {ms / args.reps:9.3f} ms {calls / args.reps:8.0f} x  "
                  f"{k[:90]}")
        sys.stdout.flush()
    tmp.cleanup()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(f"tables in {os.path.join(args.out, 'profile.json')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
