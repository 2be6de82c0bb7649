"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor mgm_tpu, so it also runs where the
card is (a machine without JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The `cuda` cases skip without a CUDA device; the rest check, on any
machine, what surrounds the kernels.
"""
import numpy as np
import pytest
import torch

from mgm_tpu_torch import MGMConfig, compute_disparity
from mgm_tpu_torch.models import get_preset
from mgm_tpu_torch.mrf import solve_mrf
from mgm_tpu_torch.ops import _build, cuda_cost, cuda_fused
from mgm_tpu_torch.ops import aggregate as tagg
from mgm_tpu_torch.ops import fused as tfused
from mgm_tpu_torch.ops import wavefront as wf
from mgm_tpu_torch.synthetic import synthetic_mrf, synthetic_pair

# The CPU cases are tiny: one intra-op thread, so torch's idle pool does
# not spin on the cores that parallel test processes share.  The other
# torch test files import this module, so the setting holds there too.
torch.set_num_threads(1)


def assert_bitwise(got, want):
    """Equal bits everywhere except NaN payloads (NaN masks must match)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    ng, nw = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(ng, nw)
    assert np.array_equal(got[~ng].view(np.uint32), want[~nw].view(np.uint32))


def _pair(rng, H, W, C):
    u = rng.integers(0, 80, (H, W, C)).astype(np.float32)
    v = rng.integers(0, 80, (H, W, C)).astype(np.float32)
    return u, v


def _sides(dmin, dmax, lr):
    L = dmax - dmin + 1
    return L, ((dmin, 0, L - 1),) + (((-dmax, 0, L - 1),) if lr else ())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _solve_planes(fn, u, v, *, ndir, mgm, sides, L, device, mode="ad",
                  group=None, use_fh=False, w8=None, tmax=float("inf"),
                  lo_px=None, hi_px=None, fh_restrict=False):
    """Every launch of a solve's fused groups (or of its group number
    `group` alone) through `fn` (the kernel or its plain version) on
    the images as K1 takes them; u, v: one pair (H, W, nch) or a stack
    of pairs (K, H, W, nch).  Returns the volume and its space count."""
    n = len(sides)
    us, vs = (u, v) if u.ndim == 4 else (u[None], v[None])
    lefts = torch.from_numpy(np.concatenate(
        [np.stack([a, b][:n]) for a, b in zip(us, vs)])).to(device)
    rights = torch.from_numpy(np.concatenate(
        [np.stack([b, a][:n]) for a, b in zip(us, vs)])).to(device)
    C = 3   # P1 and P2 of a three-channel image
    groups = tfused.split_passes(ndir, mgm)[0]
    if group is not None:
        groups = groups[group:group + 1]
    return tfused.fused_planes(lefts, rights, sides=sides, L=L,
                               groups=groups, mgm=mgm, p1=8.0 * C,
                               p2=32.0 * C, mode=mode, tmax=tmax,
                               kappa=-float(ndir - 1), use_fh=use_fh,
                               w8=None if w8 is None else w8.to(device),
                               lo_px=None if lo_px is None
                               else lo_px.to(device),
                               hi_px=None if hi_px is None
                               else hi_px.to(device),
                               fh_restrict=fh_restrict, npair=len(us),
                               wavefront=fn)


# (slope, fstep, a0, ssgn): A and B at slopes 1 and 2, V, PA and PB
@pytest.mark.parametrize("slope,a0,ssgn,fstep", [
    (1, 0, -1, 1), (2, 0, -1, 1), (1, 17, 1, 1), (2, 34, 1, 1),
    (0, 0, -1, 1), (1, 0, -1, 2), (1, 17, 1, 2)])
def test_valid_rows_match_the_column_mask(slope, a0, ssgn, fstep):
    R, C = 18, 29
    rows = np.arange(R)
    for t in range(fstep * (C - 1) + slope * (R - 1) + 1):
        num = t - a0 + ssgn * slope * rows
        want = np.flatnonzero((num >= 0) & (num % fstep == 0)
                              & (num // fstep < C))
        got = cuda_fused._valid_rows(t, a0, ssgn, slope, C, R, fstep)
        np.testing.assert_array_equal(np.array(got, dtype=np.int64), want)


def test_plain_runs_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    u, v = _pair(rng, 6, 9, 1)
    L, sides = _sides(-3, 2, True)
    n1, n2 = cuda_fused.fused_wavefront.launches, cuda_fused.wta.launches
    out, ns = _solve_planes(cuda_fused.fused_wavefront, u, v, ndir=4, mgm=2,
                            sides=sides, L=L, device="cpu")
    disp, cost = cuda_fused.wta(out, nspaces=ns, sides=sides)
    assert disp.shape == cost.shape == (2, 6, 9)
    assert (cuda_fused.fused_wavefront.launches,
            cuda_fused.wta.launches) == (n1, n2)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 4, 5, 1), device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_fused.wta(torch.empty((2, 4, 5, 3), device="meta"), nspaces=1,
                       sides=((0, 0, 2), (0, 0, 2)))
    with pytest.raises(ValueError, match="device"):
        cuda_fused.fused_wavefront(
            meta, meta, torch.empty((1, 4, 5, 3), device="meta"),
            accumulate=False, planes=((0, 0, 0, 2, 0, -1, False),),
            mspecs=((0, (0,), (True, False, False, False)),),
            combos=((1, 0),), L=3, slope=1, fstep=1, mgm=1, mode="ad",
            tmax=float("inf"), p1=1.0, p2=2.0, kappa=0.0, reverse=False)


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_library_is_keyed_by_the_sources():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert {s.name for s in _build._sources()} >= {
        "fused_wavefront.cu", "wta.cu", "wavefront.cu", "skew.cu",
        "cost.cu", "mgm_kernels.h", "mgm_device.cuh"}


@pytest.mark.cuda
@pytest.mark.parametrize("ndir,mgm,L,lr,mode", [
    (4, 2, 11, True, "ad"), (2, 4, 11, True, "ad"), (8, 1, 40, False, "ad"),
    (4, 3, 151, True, "sd"), (5, 2, 20, True, "ad")])
def test_kernels_match_plain(cuda, ndir, mgm, L, lr, mode):
    rng = np.random.default_rng(1)
    u, v = _pair(rng, 18, 29, 3)
    L, sides = _sides(-L + 5, 4, lr)
    kw = dict(ndir=ndir, mgm=mgm, sides=sides, L=L, device=cuda, mode=mode)
    got, ns = _solve_planes(cuda_fused.fused_wavefront, u, v, **kw)
    want, _ = _solve_planes(cuda_fused.fused_wavefront_plain, u, v, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got.cpu().numpy(), want.cpu().numpy())
    d1, c1 = cuda_fused.wta(got, nspaces=ns, sides=sides)
    d0, c0 = cuda_fused.wta_plain(got, nspaces=ns, sides=sides)
    torch.cuda.synchronize()
    assert_bitwise(d1.cpu().numpy(), d0.cpu().numpy())
    assert_bitwise(c1.cpu().numpy(), c0.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("ndir,mgm,group,L,lr", [
    (8, 2, 1, 11, True),     # V
    (8, 3, 1, 40, False),    # V, three coupled deps
    (4, 4, 1, 11, True),     # PB
    (8, 4, 1, 151, True),    # PA + PB, lags up to 3, rows of both signs
    (16, 4, None, 11, True)])   # A/B + PA/PB into one volume
def test_kernels_match_plain_in_every_space(cuda, ndir, mgm, group, L, lr):
    rng = np.random.default_rng(2)
    u, v = _pair(rng, 17, 29, 3)
    L, sides = _sides(-L + 5, 4, lr)
    kw = dict(ndir=ndir, mgm=mgm, sides=sides, L=L, device=cuda,
              group=group)
    got, ns = _solve_planes(cuda_fused.fused_wavefront, u, v, **kw)
    want, _ = _solve_planes(cuda_fused.fused_wavefront_plain, u, v, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got.cpu().numpy(), want.cpu().numpy())
    d1, c1 = cuda_fused.wta(got, nspaces=ns, sides=sides)
    d0, c0 = cuda_fused.wta_plain(got, nspaces=ns, sides=sides)
    torch.cuda.synchronize()
    assert_bitwise(d1.cpu().numpy(), d0.cpu().numpy())
    assert_bitwise(c1.cpu().numpy(), c0.cpu().numpy())


def _bt_blocks(rng, H, W, C):
    """[I, Imin, Imax] channel blocks of a random image."""
    i = rng.integers(0, 255, (H, W, C)).astype(np.float32)
    lo = i - rng.integers(0, 20, (H, W, C)).astype(np.float32) * 0.5
    hi = i + rng.integers(0, 20, (H, W, C)).astype(np.float32) * 0.5
    return np.concatenate([i, lo, hi], -1)


def _mode_images(rng, mode, H, W):
    """A left and a right image as K1 and K8 take them for `mode`:
    3 float32 channels, 2 random int32 census words, or BT's
    [I, Imin, Imax] blocks of 3 channels."""
    if mode == "census":
        return tuple(rng.integers(0, 2**32, (H, W, 2), dtype=np.uint64)
                     .astype(np.uint32).view(np.int32) for _ in range(2))
    if mode in ("btad", "btsd"):
        return _bt_blocks(rng, H, W, 3), _bt_blocks(rng, H, W, 3)
    return _pair(rng, H, W, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [6, 151])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("use_fh", [False, True])
@pytest.mark.parametrize("mode", cuda_cost.MODES)
def test_kernels_match_plain_in_every_mode(cuda, mode, use_fh, weights, L):
    """K1 for every cost family, SGM and FH, with and without edge
    weights, at cfg2's schedule (ndir 8, TSGM 3: A/B at slope 2 and V),
    then K2 with taps on its planes."""
    rng = np.random.default_rng(L)
    u, v = _mode_images(rng, mode, 17, 29)
    L, sides = _sides(-L + 5, 4, True)
    w8 = (torch.from_numpy(np.where(rng.random((2, 17, 29, 8)) < 0.5, 0.25,
                                    1.0).astype(np.float32))
          if weights else None)
    kw = dict(ndir=8, mgm=3, sides=sides, L=L, device=cuda, mode=mode,
              use_fh=use_fh, w8=w8, tmax=40.0)
    got, ns = _solve_planes(cuda_fused.fused_wavefront, u, v, **kw)
    want, _ = _solve_planes(cuda_fused.fused_wavefront_plain, u, v, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got.cpu().numpy(), want.cpu().numpy())
    n = cuda_fused.wta.launches
    res = cuda_fused.wta(got, nspaces=ns, sides=sides, want_taps=True)
    assert cuda_fused.wta.launches == n + 1
    ref = cuda_fused.wta_plain(got, nspaces=ns, sides=sides, want_taps=True)
    torch.cuda.synchronize()
    assert res[2].shape == (2, 17, 4, 29)
    for a, b in zip(res, ref):
        assert_bitwise(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_wta_taps_keep_nan(cuda):
    """K2's taps read the raw space sums: NaN and -inf sums come out as
    they are (the TPU kernel's min over a one-hot select keeps NaN)."""
    rng = np.random.default_rng(7)
    vol = rng.uniform(0, 50, (4, 5, 9, 7)).astype(np.float32)
    vol[0, 1, 2, :6] = np.nan     # the winner is label 6: NaN taps
    vol[2, 3, 4, 2:] = -np.inf
    vol[1, 0, 0] = np.inf          # an all-invalid window: idx 0
    sides = ((0, 0, 6), (-3, 1, 5))
    vt = torch.from_numpy(vol).to(cuda)
    got = cuda_fused.wta(vt, nspaces=2, sides=sides, want_taps=True)
    want = cuda_fused.wta_plain(vt, nspaces=2, sides=sides, want_taps=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert_bitwise(a.cpu().numpy(), b.cpu().numpy())
    assert np.isnan(got[2].cpu().numpy()).any()


def _pp_windows(rng, N, H, W, L):
    """(N, H, W) int32 per-pixel label windows: random, some one label
    wide, some empty (lo > hi)."""
    lo = rng.integers(0, L - 1, (N, H, W)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 6, (N, H, W)), L - 1).astype(
        np.int32)
    hi[:, 0, :3] = lo[:, 0, :3] - 1
    return torch.from_numpy(lo), torch.from_numpy(hi)


# K1 under per-pixel windows: SGM at TSGM 2 (A/B), census + FH at
# TSGM 3 (A/B and V, fh_restrict on), FH at TSGM 2 unweighted
# (fh_restrict off by aggregate()'s rule) and weighted (on)
@pytest.mark.cuda
@pytest.mark.parametrize("ndir,mgm,mode,use_fh,weights,restrict", [
    (4, 2, "ad", False, False, False), (8, 3, "census", True, False, True),
    (4, 2, "ad", True, False, False), (4, 2, "ad", True, True, True)])
@pytest.mark.parametrize("L", [6, 151])
def test_per_pixel_windows_match_plain(cuda, ndir, mgm, mode, use_fh, weights,
                                       restrict, L):
    rng = np.random.default_rng(L + ndir)
    u, v = _mode_images(rng, mode, 17, 29)
    L, sides = _sides(-L + 5, 4, True)
    lo, hi = _pp_windows(rng, 2, 17, 29, L)
    w8 = (torch.from_numpy(np.where(rng.random((2, 17, 29, 8)) < 0.5, 0.25,
                                    1.0).astype(np.float32))
          if weights else None)
    kw = dict(ndir=ndir, mgm=mgm, sides=tuple((g, 0, L - 1) for g, _, _
                                              in sides),
              L=L, device=cuda, mode=mode, use_fh=use_fh, w8=w8, tmax=40.0,
              lo_px=lo, hi_px=hi, fh_restrict=restrict)
    got, _ = _solve_planes(cuda_fused.fused_wavefront, u, v, **kw)
    want, _ = _solve_planes(cuda_fused.fused_wavefront_plain, u, v, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got.cpu().numpy(), want.cpu().numpy())
    # the windows bite: +inf outside them, and an empty window's
    # all-invalid costs are 0, not +inf
    assert np.isinf(got.cpu().numpy()).any()


# K1's one cluster launch against its plain version in each space (A/B
# at slopes 1 and 2, V, PA/PB) for SGM, FH, FH with edge weights, FH
# under per-pixel windows with fh_restrict, and three pairs, at each
# instance (L 6 and 48: two rows a warp; 60, 151, 200), on 40 rows: with
# k1_plan's sizes for the card (a unit over several clusters, bands of
# one or two rows, so counts pass between CTAs and clusters on every
# row) three times (equal bits each time: a missing wait shows as a
# race), then planned for a card of one SM (one CTA a unit, several rows
# a warp)
K1_SPACES = {"A/B slope 1": (4, 2, 0), "A/B slope 2": (8, 3, 0),
             "V": (8, 3, 1), "PA/PB": (8, 4, 1)}
K1_KINDS = ("sgm", "fh", "fh weights", "fh per-pixel restrict", "3 pairs")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [6, 48, 60, 151, 200])
@pytest.mark.parametrize("kind", K1_KINDS)
@pytest.mark.parametrize("space", K1_SPACES)
def test_k1_cluster_launch_matches_plain(cuda, space, kind, L, monkeypatch):
    ndir, mgm, group = K1_SPACES[space]
    R, W, K = 40, 23, 3 if kind == "3 pairs" else 1
    rng = np.random.default_rng(L + ndir + mgm)
    pairs = [_pair(rng, R, W, 3) for _ in range(K)]
    us, vs = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    L, sides = _sides(-L + 5, 4, True)
    kw = dict(ndir=ndir, mgm=mgm, sides=sides, L=L, device=cuda,
              group=group, use_fh=kind != "sgm", tmax=40.0)
    if "weights" in kind:
        kw["w8"] = torch.from_numpy(np.where(
            rng.random((2 * K, R, W, 8)) < 0.5, 0.25, 1.0).astype(np.float32))
    if "per-pixel" in kind:
        kw["lo_px"], kw["hi_px"] = _pp_windows(rng, 2 * K, R, W, L)
        kw.update(fh_restrict=True,
                  sides=tuple((g, 0, L - 1) for g, _, _ in sides))
    want, _ = _solve_planes(cuda_fused.fused_wavefront_plain, us, vs, **kw)
    for sms in (None, None, None, 1):
        if sms:
            monkeypatch.setattr(cuda_fused, "_sms", lambda index: sms)
        got, _ = _solve_planes(cuda_fused.fused_wavefront, us, vs, **kw)
        torch.cuda.synchronize()
        assert_bitwise(got.cpu().numpy(), want.cpu().numpy())


# batched pairs: cfg1's A/B group, the V group with FH and weights, and
# the parity spaces, with and without the LR check
@pytest.mark.cuda
@pytest.mark.parametrize("ndir,mgm,use_fh,weights,lr", [
    (4, 2, False, False, True), (8, 3, True, True, True),
    (8, 4, False, False, False)])
def test_batched_kernels_equal_per_pair(cuda, ndir, mgm, use_fh, weights,
                                        lr):
    """K1 and K2 (+ taps) over K = 3 pairs in one launch each equal the
    per-pair launches bitwise; K1's launch count is one pair's."""
    K, H, W = 3, 17, 29
    rng = np.random.default_rng(ndir + mgm)
    pairs = [_pair(rng, H, W, 3) for _ in range(K)]
    us, vs = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    L, sides = _sides(-20, 4, lr)
    ns = len(sides)
    w8 = (torch.from_numpy(np.where(rng.random((K * ns, H, W, 8)) < 0.5,
                                    0.25, 1.0).astype(np.float32))
          if weights else None)
    kw = dict(ndir=ndir, mgm=mgm, sides=sides, L=L, device=cuda,
              use_fh=use_fh)
    n1 = cuda_fused.fused_wavefront.launches
    got, nsp = _solve_planes(cuda_fused.fused_wavefront, us, vs, w8=w8, **kw)
    one_pair = cuda_fused.fused_wavefront.launches - n1
    res = cuda_fused.wta(got, nspaces=nsp, sides=sides, npair=K,
                         want_taps=True)
    torch.cuda.synchronize()
    for k in range(K):
        n1 = cuda_fused.fused_wavefront.launches
        want, _ = _solve_planes(
            cuda_fused.fused_wavefront, us[k], vs[k],
            w8=None if w8 is None else w8[k * ns:(k + 1) * ns], **kw)
        assert cuda_fused.fused_wavefront.launches - n1 == one_pair
        ref = cuda_fused.wta(want, nspaces=nsp, sides=sides, want_taps=True)
        torch.cuda.synchronize()
        gv = got.view(nsp, K, ns, H, W, L)[:, k].reshape(nsp * ns, H, W, L)
        assert_bitwise(gv.cpu().numpy(), want.cpu().numpy())
        for a, b in zip(res, ref):
            assert_bitwise(a[k * ns:(k + 1) * ns].cpu().numpy(),
                           b.cpu().numpy())


@pytest.mark.cuda
def test_assemble_swta_ndir1_keeps_nan(cuda):
    """At ndir 1 with the overcount fix, S is NaN (0 * inf) where the S
    window reaches outside the CC window, on the card as on the CPU."""
    rng = np.random.default_rng(9)
    lsum = torch.from_numpy(rng.uniform(-9, 9, (2, 5, 7, 9)).astype(
        np.float32))
    lo, hi = _pp_windows(rng, 2, 5, 7, 9)
    s_lo, s_hi = (lo - 1).clamp(min=0), (hi + 1).clamp(max=8)
    sides = ((-3, 0, 8), (-5, 0, 8))
    kw = dict(sides=sides, L=9, ndir=1, fix_overcount=True)
    got = tfused.assemble_swta(lsum.to(cuda), s_lo.to(cuda), s_hi.to(cuda),
                               lo_px=lo.to(cuda), hi_px=hi.to(cuda), **kw)
    want = tfused.assemble_swta(lsum, s_lo, s_hi, lo_px=lo, hi_px=hi, **kw)
    for a, b in zip(got, want):
        assert_bitwise(a.cpu().numpy(), b.numpy())
    assert np.isnan(got[0].cpu().numpy()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("fast_ad", dict(mgm=2)), ("census_tl", {}),
    ("fast_ad", dict(iterations=3)), ("ncc", dict(iterations=2))])
def test_item6_pipeline_cuda_equals_cpu(cuda, name, kw):
    """Per-pixel windows (and TSGM_ITER) through compute_disparity on a
    crop: CUDA equal to the CPU run for every output."""
    u, v, d = synthetic_pair(24, 40, -8, 4, seed=3)
    cfg = get_preset(name, dmin=-8, dmax=4, test_lr=True, **kw)
    win = {}
    if cfg.iterations == 1:
        win = dict(dmin_img=(d - 3).astype(np.float32),
                   dmax_img=(d + 2).astype(np.float32))
    got = compute_disparity(u, v, cfg, device=cuda, **win)
    want = compute_disparity(u, v, cfg, device="cpu", **win)
    for k in got:
        assert_bitwise(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", cuda_cost.MODES)
@pytest.mark.parametrize("gmin,L", [(-7, 12), (-60, 151), (3, 5)])
def test_cost_kernel_matches_plain(cuda, mode, gmin, L):
    rng = np.random.default_rng(3)
    H, W = 13, 37
    if mode == "census":
        u, v = (rng.integers(0, 2**32, (H, W, 2), dtype=np.uint64)
                .astype(np.uint32).view(np.int32) for _ in range(2))
    elif mode in ("btad", "btsd"):
        u, v = _bt_blocks(rng, H, W, 3), _bt_blocks(rng, H, W, 3)
    else:
        u, v = _pair(rng, H, W, 3)
    ut, vt = torch.from_numpy(u).to(cuda), torch.from_numpy(v).to(cuda)
    n = cuda_cost.pointwise_volume.launches
    got = cuda_cost.pointwise_volume(ut, vt, gmin=gmin, L=L, mode=mode)
    assert cuda_cost.pointwise_volume.launches == n + 1
    want = cuda_cost.pointwise_volume_plain(ut, vt, gmin=gmin, L=L,
                                            mode=mode)
    torch.cuda.synchronize()
    assert_bitwise(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cfg1_pipeline_cuda_equals_cpu(cuda):
    u, v, _ = synthetic_pair(24, 40, -8, 4, seed=3)
    cfg = MGMConfig(dmin=-120, dmax=30, ndir=4, mgm=2, distance="ad", p1=8,
                    p2=32, test_lr=True)
    n1, n2 = cuda_fused.fused_wavefront.launches, cuda_fused.wta.launches
    got = compute_disparity(u, v, cfg, device=cuda)
    # one forward and one backward launch; both sides are planes of each
    assert cuda_fused.fused_wavefront.launches == n1 + 2
    assert cuda_fused.wta.launches == n2 + 1
    want = compute_disparity(u, v, cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert_bitwise(got[k], want[k])


# preset -> (K1, K2, K8 launches) on the crop: two K1 groups (A/B and V,
# or A/B and PA/PB) of two launches; full_16dir's knight passes through
# K8 (one call a side) and K6/K5/K7, no K2
PRESET_LAUNCHES = {"census_tl": (4, 1, 0), "sobelx_tl": (4, 1, 0),
                   "satellite": (4, 1, 0), "bt": (4, 1, 0),
                   "full_16dir": (4, 0, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PRESET_LAUNCHES))
def test_presets_cuda_equal_cpu(cuda, name):
    u, v, _ = synthetic_pair(24, 40, -8, 4, seed=3)
    cfg = get_preset(name, dmin=-8, dmax=4, test_lr=True)
    n = (cuda_fused.fused_wavefront.launches, cuda_fused.wta.launches,
         cuda_cost.pointwise_volume.launches)
    got = compute_disparity(u, v, cfg, device=cuda)
    assert tuple(
        a - b for a, b in zip((cuda_fused.fused_wavefront.launches,
                               cuda_fused.wta.launches,
                               cuda_cost.pointwise_volume.launches), n)
    ) == PRESET_LAUNCHES[name]
    want = compute_disparity(u, v, cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert_bitwise(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("ndir,mgm,k1,k8", [
    (16, 2, 4, 2),     # A/B + V groups, knight passes through K8
    (4, 4, 4, 0),      # A + PB, K2
    (8, 3, 4, 0)])     # A/B + V, K2
def test_fused_schedules_cuda_equal_cpu(cuda, ndir, mgm, k1, k8):
    u, v, _ = synthetic_pair(24, 40, -8, 4, seed=3)
    cfg = MGMConfig(dmin=-8, dmax=4, ndir=ndir, mgm=mgm, distance="ad",
                    p1=8, p2=32, test_lr=True)
    n1 = cuda_fused.fused_wavefront.launches
    n8 = cuda_cost.pointwise_volume.launches
    got = compute_disparity(u, v, cfg, device=cuda)
    assert cuda_fused.fused_wavefront.launches == n1 + k1
    assert cuda_cost.pointwise_volume.launches == n8 + k8
    want = compute_disparity(u, v, cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert_bitwise(got[k], want[k])


# ---- the dense path's kernels: K6 skew, K7 unskew, K5 wavefront_scan ----

@pytest.mark.parametrize("slope", [1, 2])
@pytest.mark.parametrize("dtype,fill", [(torch.float32, float("inf")),
                                        (torch.int32, -1)])
def test_skew_plain_is_the_definition(slope, dtype, fill):
    """K6's plain version: out[a, r, slope*r + c, b] = x[a, r, c, b] and
    `fill` elsewhere; K7's plain version inverts it (exact copies)."""
    rng = np.random.default_rng(2)
    A, R, C, B = 3, 5, 7, 2
    x = torch.from_numpy(rng.integers(-50, 50, (A, R, C, B))).to(dtype)
    y = wf.skew(x, fill, slope)           # CPU: the plain version
    T = C + slope * (R - 1)
    assert y.shape == (A, R, T, B) and y.dtype == dtype
    want = torch.full((A, R, T, B), fill, dtype=dtype)
    for r in range(R):
        for c in range(C):
            want[:, r, slope * r + c] = x[:, r, c]
    assert torch.equal(y, want)
    assert torch.equal(wf.unskew(y, C, slope), x)


def test_dense_wrappers_refuse_other_devices():
    meta = torch.empty((2, 3, 4, 5), device="meta")
    with pytest.raises(ValueError, match="device"):
        wf.skew(meta, 0.0, 1)
    with pytest.raises(ValueError, match="device"):
        wf.unskew(meta, 2, 1)
    with pytest.raises(ValueError, match="device"):
        wf.wavefront_scan(meta, C=2, p1=1.0, p2=2.0, mgm=1, dir2off=(0,),
                          slope=1)


def test_dense_plain_runs_on_cpu_without_counting():
    unary, w, _ = synthetic_mrf(7, 9, 6, seed=1)
    n = (wf.skew.launches, wf.unskew.launches, wf.wavefront_scan.launches)
    lab = solve_mrf(unary, 8, 8.0, 32.0, 2, 0, w, device="cpu")
    assert lab.shape == (7, 9) and lab.dtype == np.float32
    assert (wf.skew.launches, wf.unskew.launches,
            wf.wavefront_scan.launches) == n


def _group_case(rng, *, N, H, W, L, ndir, mgm, use_fh=False,
                use_weights=False, fh_restrict=False, pick=0):
    """One pass group's canonical inputs and K5 arguments on the CPU."""
    lo = np.zeros((N, H, W), np.int32)
    hi = np.full((N, H, W), L - 1, np.int32)
    if fh_restrict:
        lo = rng.integers(0, L - 2, (N, H, W)).astype(np.int32)
        hi = (lo + rng.integers(1, L - 1, (N, H, W))).clip(max=L - 1)
        hi = hi.astype(np.int32)
    cc = rng.uniform(0, 50, (N, H, W, L)).astype(np.float32)
    inw = (np.arange(L) >= lo[..., None]) & (np.arange(L) <= hi[..., None])
    cc = np.where(inw, cc, np.inf).astype(np.float32)
    w8 = np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0)
    pids = tagg._pass_groups(ndir, mgm)[pick]
    plan = tagg.group_plan(pids, H, W, mgm)
    canon = tagg.canonical_inputs(
        plan, torch.from_numpy(cc), torch.from_numpy(w8.astype(np.float32)),
        torch.from_numpy(lo), torch.from_numpy(hi), use_weights=use_weights,
        fh_restrict=fh_restrict)
    kw = tagg.scan_kwargs(plan, p1=8.0, p2=32.0, mgm=mgm, use_fh=use_fh,
                          use_weights=use_weights, fh_restrict=fh_restrict)
    return canon, plan, kw


# (ndir, mgm, fh, weights, fh_restrict, group): slope 1 and 2, SGM and
# FH, weights, the window restriction, knight passes (lag 3), mgm 1-4
DENSE_CASES = [
    (8, 1, False, False, False, 0), (8, 2, False, False, False, 0),
    (8, 2, False, False, False, 2), (8, 3, True, True, False, 3),
    (8, 4, False, True, False, 1), (8, 3, True, True, True, 2),
    (16, 4, False, False, False, 4), (16, 2, True, False, False, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [6, 151])
@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_kernels_match_plain(cuda, case, L):
    ndir, mgm, fh, weights, restrict, pick = case
    rng = np.random.default_rng(L + pick)
    canon, plan, kw = _group_case(rng, N=2, H=13, W=17, L=L, ndir=ndir,
                                  mgm=mgm, use_fh=fh, use_weights=weights,
                                  fh_restrict=restrict, pick=pick)
    canon = tuple(None if x is None else x.to(cuda) for x in canon)
    got = tagg.skewed_inputs(canon, plan.slope)
    want = tagg.skewed_inputs(canon, plan.slope, skew=wf.skew_plain)
    for g, w in zip(got, want):   # K6 copies 32-bit words as they are
        if w is not None:
            assert np.array_equal(g.cpu().numpy().view(np.uint32),
                                  w.cpu().numpy().view(np.uint32))
    vol = wf.wavefront_scan(got[0].clone(), *got[1:], **kw)
    ref = wf.wavefront_scan_plain(want[0].clone(), *want[1:], **kw)
    torch.cuda.synchronize()
    assert_bitwise(vol.cpu().numpy(), ref.cpu().numpy())
    assert_bitwise(wf.unskew(vol, plan.C, plan.slope).cpu().numpy(),
                   wf.unskew_plain(ref, plan.C, plan.slope).cpu().numpy())


@pytest.mark.cuda
def test_dense_paths_cuda_equal_cpu(cuda):
    unary, w, _ = synthetic_mrf(20, 27, 12, seed=4)
    for vtype in (0, 1):
        n = wf.wavefront_scan.launches
        got = solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w, device=cuda)
        assert wf.wavefront_scan.launches == n + 4   # one per pass group
        assert_bitwise(got, solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w,
                                      device="cpu"))
    u, v, _ = synthetic_pair(24, 40, -8, 4, seed=3)
    cfg = get_preset("ncc", dmin=-8, dmax=4)
    got = compute_disparity(u, v, cfg, device=cuda)
    want = compute_disparity(u, v, cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert_bitwise(got[k], want[k])
