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
from mgm_tpu_torch.ops import _build, cuda_fused
from mgm_tpu_torch.ops import aggregate as tagg
from mgm_tpu_torch.ops import fused as tfused
from mgm_tpu_torch.ops import wavefront as wf
from mgm_tpu_torch.synthetic import synthetic_mrf, synthetic_pair


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


def _solve_planes(fn, u, v, *, ndir, mgm, sides, L, device, mode="ad"):
    """Both launches of a solve through `fn` (the kernel or its plain
    version); returns the volume and the group's space count."""
    n = len(sides)
    lefts = torch.from_numpy(np.stack([u, v][:n])).to(device)
    rights = torch.from_numpy(np.stack([v, u][:n])).to(device)
    C = u.shape[-1]
    return tfused.fused_planes(lefts, rights, sides=sides, L=L, ndir=ndir,
                               mgm=mgm, p1=8.0 * C, p2=32.0 * C, mode=mode,
                               tmax=float("inf"), kappa=-float(ndir - 1),
                               wavefront=fn)


@pytest.mark.parametrize("slope,a0,ssgn", [(1, 0, -1), (2, 0, -1),
                                           (1, 17, 1), (2, 34, 1)])
def test_valid_rows_match_the_column_mask(slope, a0, ssgn):
    R, C = 18, 29
    rows = np.arange(R)
    for t in range(C + slope * (R - 1)):
        col = t - a0 + ssgn * slope * rows
        want = np.flatnonzero((col >= 0) & (col < C))
        r0, r1 = cuda_fused._valid_rows(t, a0, ssgn, slope, C, R)
        np.testing.assert_array_equal(np.arange(r0, r1), want)


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
            meta, meta, None, planes=((0, 0, 0, 2, 0, -1, False),),
            mspecs=((0, (0,), (True, False, False, False)),),
            combos=((1, 0),), L=3, slope=1, mgm=1, mode="ad",
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
        "mgm_kernels.h"}


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
