"""The port's fused solve against mgm_tpu.

The scheduling must equal mgm_tpu's exactly.  The solve (the plain
PyTorch versions of the kernels on CPU: K1 and K2, and for ndir > 8
K8 and K6/K5/K7 on the knight passes) is held against
mgm_tpu.solver.mgm_solve, the JAX package's dense XLA path, for every
cost family in flight, the SGM and truncated-linear potentials, and
edge weights.  The two sum in different orders (the fused path folds
kappa*CC per space and sums the spaces A, B, V, PA, PB;
docs/ARCHITECTURE.md "Numerical-parity policy"), so the rule of
tests/test_fused.py applies: equal finite masks, costs within
3e-5 * scale, and disparities that differ only at argmin ties.  At
TSGM = 1 every order is exact (min-plus over integers and halves:
integer images, census costs of two words, BT's half samples, integer
P1): bitwise.  K2's subpixel taps equal mgm_tpu's taps_from_S bitwise.

Batched pairs equal each pair's own solve bitwise; per-pixel windows
(and TSGM_ITER's S windows) hold against the dense solver on volumes
built with the same windows.

The kernels against their plain versions are in test_torch_kernels.py,
which needs no JAX and so runs on a machine with a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgm_tpu.ops import fused as jfused
from mgm_tpu.ops.cost import build_cost_volume
from mgm_tpu.ops.refine import taps_from_S as jtaps_from_S
from mgm_tpu.solver import mgm_solve
from mgm_tpu_torch.ops import fused as tfused

from test_torch_kernels import _pair, _sides, assert_bitwise


@pytest.mark.parametrize("ndir", range(1, 17))
@pytest.mark.parametrize("mgm", range(1, 5))
def test_split_passes_matches(ndir, mgm):
    assert tfused.split_passes(ndir, mgm) == jfused.split_passes(ndir, mgm)
    for p in range(ndir):
        assert tfused.fused_spec(p, mgm) == jfused.fused_spec(p, mgm)


def _dense(u, v, sides, L, *, ndir, mgm, mode, trunc, fix, p1, p2, fh=False,
           w8=None):
    N = len(sides)
    H, W = u.shape[:2]
    lefts, rights = [u, v][:N], [v, u][:N]
    lo = jnp.zeros((N, H, W), jnp.int32)
    hi = jnp.full((N, H, W), L - 1, jnp.int32)
    cc = jnp.stack([
        build_cost_volume(jnp.asarray(lefts[n]), jnp.asarray(rights[n]),
                          lo[n], hi[n], g, distance=mode, L=L,
                          trunc_dist=trunc, backend="xla")
        for n, (g, _, _) in enumerate(sides)])
    gmins = jnp.asarray([g for g, _, _ in sides], jnp.int32)
    S, d, c = mgm_solve(cc, None if w8 is None else jnp.asarray(w8), lo, hi,
                        lo, hi, gmins, p1=p1, p2=p2, ndir=ndir, mgm=mgm,
                        use_fh=fh, use_weights=w8 is not None,
                        per_pixel=False, fix_overcount=fix)
    return np.asarray(S), np.asarray(d), np.asarray(c)


def _inputs(rng, mode, H, W, C, words=2):
    """(JAX's images, the port's): float32 images, or for census
    `words` random packed words a pixel (costs in halves or integers:
    exact sums), uint32 for mgm_tpu and their int32 view for the
    port."""
    if mode != "census":
        u, v = _pair(rng, H, W, C)
        return (u, v), (u, v)
    u, v = (rng.integers(0, 2**32, (H, W, words), dtype=np.uint64)
            .astype(np.uint32) for _ in range(2))
    return (u, v), (u.view(np.int32), v.view(np.int32))


def _weights(rng, N, H, W):
    """Edge weights of each side in {0.5, 1} (aP2 = 0.5)."""
    return np.where(rng.random((N, H, W, 8)) < 0.5, 0.5, 1.0).astype(
        np.float32)


CASES = [
    dict(ndir=1, mgm=1), dict(ndir=1, mgm=1, lr=False),
    dict(ndir=2, mgm=2), dict(ndir=4, mgm=1), dict(ndir=4, mgm=2),
    dict(ndir=4, mgm=2, lr=False), dict(ndir=4, mgm=3, D=2),
    dict(ndir=5, mgm=2, slope=2, D=3),        # slope 2
    dict(ndir=2, mgm=4, slope=2, D=3),        # slope 2, four coupled deps
    dict(ndir=8, mgm=1, D=2),
    dict(ndir=4, mgm=2, fix=False), dict(ndir=4, mgm=1, fix=False),
    dict(ndir=4, mgm=1, mode="sd"), dict(ndir=4, mgm=2, mode="sd"),
    dict(ndir=4, mgm=2, trunc=20.0), dict(ndir=4, mgm=1, trunc=20.0),
    # the V group (slope 0)
    dict(ndir=8, mgm=2, groups=(2, 0), D=3),
    dict(ndir=8, mgm=3, groups=(2, 0), D=3),
    # the packed-parity group (P_SLOPE): PB alone, PA + PB
    dict(ndir=4, mgm=4, groups=(2, -1), D=3),
    dict(ndir=8, mgm=4, groups=(2, -1), D=3),
    # knight passes left over for the dense path
    dict(ndir=9, mgm=1, left=1, D=2), dict(ndir=16, mgm=1, left=8, D=2),
    dict(ndir=16, mgm=2, groups=(2, 0), left=8, D=3),
    dict(ndir=16, mgm=4, groups=(2, -1), left=8, D=3),
    dict(ndir=16, mgm=2, groups=(2, 0), left=8, D=3, mode="sd"),
    # the in-flight census (2 words) and BT costs
    dict(ndir=4, mgm=1, mode="census"), dict(ndir=4, mgm=1, mode="btad"),
    dict(ndir=4, mgm=1, mode="btsd"),
    # truncation at trunc_dist * (census words), not * (image channels)
    dict(ndir=4, mgm=1, mode="census", trunc=3.0, words=1),
    # the truncated-linear potential: TSGM 1, and cfg2's schedule
    dict(ndir=4, mgm=1, fh=True),
    dict(ndir=8, mgm=3, groups=(2, 0), D=3, fh=True, mode="census"),
    # edge weights: SGM at TSGM 2 (no update_cost2 halving), and FH
    dict(ndir=4, mgm=2, weights=True),
    dict(ndir=4, mgm=2, weights=True, fh=True),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[str(sorted(c.items())) for c in CASES])
def test_plain_solve_matches_dense(rng, case):
    kw = dict(lr=True, mode="ad", trunc=float("inf"), fix=True, fh=False,
              weights=False)
    kw.update(case)
    ndir, mgm = kw["ndir"], kw["mgm"]
    # the schedule's group slopes, deepest front lag (D) and leftovers
    groups, leftover = tfused.split_passes(ndir, mgm)
    assert tuple(g[0] for g in groups) == kw.get("groups",
                                                 (kw.get("slope", 1),))
    lags = [lag for _, _, launches in groups for _, ms in launches
            for *_, ranks, _ in ms for lag, _ in ranks]
    assert max(lags) == kw.get("D", 1)
    assert len(leftover) == kw.get("left", 0)

    H, W, C, dmin, dmax = 18, 29, 2, -6, 4
    (ju, jv), (u, v) = _inputs(rng, kw["mode"], H, W, C,
                               kw.get("words", 2))
    L, sides = _sides(dmin, dmax, kw["lr"])
    w8 = _weights(rng, len(sides), H, W) if kw["weights"] else None
    p1, p2 = 8.0 * C, 32.0 * C
    S0, d0, c0 = _dense(ju, jv, sides, L, ndir=ndir, mgm=mgm,
                        mode=kw["mode"], trunc=kw["trunc"], fix=kw["fix"],
                        p1=p1, p2=p2, fh=kw["fh"], w8=w8)
    taps, d1, c1 = tfused.mgm_solve_fused(
        torch.from_numpy(u), torch.from_numpy(v),
        None if w8 is None else torch.from_numpy(w8), sides=sides, L=L,
        ndir=ndir, mgm=mgm, p1=p1, p2=p2, mode=kw["mode"],
        trunc_dist=kw["trunc"], fix_overcount=kw["fix"], use_fh=kw["fh"])
    assert taps is None
    d1, c1 = d1.numpy(), c1.numpy()
    if mgm == 1:
        assert_bitwise(d1, d0)
        assert_bitwise(c1, c0)
        return
    np.testing.assert_array_equal(np.isfinite(c1), np.isfinite(c0))
    f0 = np.isfinite(S0)
    scale = max(1.0, np.abs(S0[f0]).max())
    np.testing.assert_allclose(c1, c0, atol=3e-5 * scale, rtol=1e-5,
                               equal_nan=True)
    for n, y, x in np.argwhere(d0 != d1):
        la = int(d0[n, y, x]) - sides[n][0]
        lb = int(d1[n, y, x]) - sides[n][0]
        assert abs(S0[n, y, x, la] - S0[n, y, x, lb]) <= 3e-5 * scale, \
            f"non-tie disparity mismatch at {(n, y, x)}"


# (ndir, mgm, fh, mode): cfg2's schedule (A/B + V, census, FH) and
# A + PB at TSGM 4
TAP_CASES = [(8, 3, True, "census"), (4, 4, False, "ad")]


@pytest.mark.parametrize("ndir,mgm,fh,mode", TAP_CASES)
def test_taps_match_taps_from_S(rng, ndir, mgm, fh, mode):
    """K2's taps (its plain version) equal mgm_tpu's taps_from_S on the
    assembled S, bitwise: the same space sum in the same order, read at
    the same clipped labels; disp and cost are those of the run
    without taps."""
    H, W, C = 18, 29, 2
    _, (u, v) = _inputs(rng, mode, H, W, C)
    L, sides = _sides(-6, 4, True)
    kw = dict(sides=sides, L=L, ndir=ndir, mgm=mgm, p1=8.0 * C, p2=32.0 * C,
              mode=mode, trunc_dist=float("inf"), fix_overcount=True,
              use_fh=fh)
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    taps, disp, cost = tfused.mgm_solve_fused(ut, vt, want_taps=True, **kw)
    _, d2, c2 = tfused.mgm_solve_fused(ut, vt, **kw)
    assert_bitwise(disp.numpy(), d2.numpy())
    assert_bitwise(cost.numpy(), c2.numpy())
    N = len(sides)
    vol, nspaces = tfused.fused_planes(
        torch.stack([ut, vt]), torch.stack([vt, ut]), sides=sides, L=L,
        groups=tfused.split_passes(ndir, mgm)[0], mgm=mgm, p1=kw["p1"],
        p2=kw["p2"], mode=mode, tmax=float("inf"), kappa=-float(ndir - 1),
        use_fh=fh)
    S, d3, _ = tfused.assemble_swta(
        tfused.assemble_groups(vol, nspaces=nspaces, N=N), sides=sides,
        L=L, ndir=ndir, fix_overcount=True)
    assert_bitwise(d3.numpy(), disp.numpy())
    gm = jnp.asarray([g for g, _, _ in sides], jnp.int32)
    want = jtaps_from_S(jnp.asarray(S.numpy()), jnp.asarray(disp.numpy()), gm)
    assert taps.shape == (N, H, 4, W)
    assert_bitwise(taps.numpy(), np.asarray(want))


# batched pairs: cfg1's schedule, the V group with FH and weights, and
# the knight passes (the dense path batched too), with and without the
# LR check
BATCH_CASES = [dict(ndir=4, mgm=2), dict(ndir=8, mgm=3, fh=True, weights=True),
               dict(ndir=16, mgm=1), dict(ndir=4, mgm=1, lr=False)]


@pytest.mark.parametrize("case", BATCH_CASES,
                         ids=[str(sorted(c.items())) for c in BATCH_CASES])
def test_batched_solve_equals_per_pair(rng, case):
    """K pairs in one solve (K1's and K2's pair axis, plain versions)
    give each pair's own solve bitwise, taps included."""
    K, H, W, C = 3, 12, 17, 2
    pairs = [_pair(rng, H, W, C) for _ in range(K)]
    L, sides = _sides(-5, 3, case.get("lr", True))
    ns = len(sides)
    w8 = (_weights(rng, K * ns, H, W) if case.get("weights")
          else None)
    kw = dict(L=L, ndir=case["ndir"], mgm=case["mgm"], p1=8.0 * C,
              p2=32.0 * C, mode="ad", trunc_dist=float("inf"),
              fix_overcount=True, use_fh=case.get("fh", False),
              want_taps=True)
    got = tfused.mgm_solve_fused(
        torch.from_numpy(np.stack([p[0] for p in pairs])),
        torch.from_numpy(np.stack([p[1] for p in pairs])),
        None if w8 is None else torch.from_numpy(w8), sides=sides * K, **kw)
    for k, (u, v) in enumerate(pairs):
        want = tfused.mgm_solve_fused(
            torch.from_numpy(u), torch.from_numpy(v),
            None if w8 is None else torch.from_numpy(w8[k * ns:(k + 1) * ns]),
            sides=sides, **kw)
        for g, w in zip(got, want):
            assert_bitwise(g[k * ns:(k + 1) * ns].numpy(), w.numpy())


def _pp_windows(rng, N, H, W, L):
    """(N, H, W) int32 label windows: random, some one label wide, some
    empty after truncation (lo > hi)."""
    lo = rng.integers(0, L - 1, (N, H, W)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 5, (N, H, W)), L - 1).astype(
        np.int32)
    hi[:, 0, :3] = lo[:, 0, :3] - 1
    return lo, hi


# per-pixel windows through the fused solve: cfg1 at TSGM 1 (bitwise),
# FH at TSGM 1 and 3 (fh_restrict on) and unweighted FH at TSGM 2 (off
# by aggregate()'s rule), the knight passes (windows in the dense
# leftover path), and TSGM_ITER's S windows
PP_CASES = [dict(ndir=4, mgm=1), dict(ndir=4, mgm=1, fh=True),
            dict(ndir=8, mgm=3, fh=True), dict(ndir=4, mgm=2, fh=True),
            dict(ndir=16, mgm=1), dict(ndir=4, mgm=1, s_win=True)]


@pytest.mark.parametrize("case", PP_CASES,
                         ids=[str(sorted(c.items())) for c in PP_CASES])
def test_per_pixel_solve_matches_dense(rng, case):
    """mgm_solve_fused with lo_px/hi_px (and s_lo/s_hi) against
    mgm_tpu's dense solver on the volume built with the same windows:
    bitwise at TSGM 1, the module docstring's rule otherwise."""
    ndir, mgm, fh = case["ndir"], case["mgm"], case.get("fh", False)
    H, W, C = 14, 21, 2
    u, v = _pair(rng, H, W, C)
    L, sides = _sides(-6, 4, True)
    lo, hi = _pp_windows(rng, 2, H, W, L)
    s_lo, s_hi = lo, hi
    if case.get("s_win"):
        s_lo = np.maximum(lo, rng.integers(0, 4, lo.shape)).astype(np.int32)
        s_hi = np.minimum(hi, rng.integers(6, L, hi.shape)).astype(np.int32)
    p1, p2 = 8.0 * C, 32.0 * C
    cc = jnp.stack([build_cost_volume(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(lo[n]),
        jnp.asarray(hi[n]), g, distance="ad", L=L, trunc_dist=float("inf"),
        backend="xla") for n, ((a, b), (g, _, _)) in enumerate(
            zip(((u, v), (v, u)), sides))])
    gm = jnp.asarray([g for g, _, _ in sides], jnp.int32)
    S0, d0, c0 = (np.asarray(x) for x in mgm_solve(
        cc, None, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(s_lo),
        jnp.asarray(s_hi), gm, p1=p1, p2=p2, ndir=ndir, mgm=mgm, use_fh=fh,
        use_weights=False, per_pixel=True, fix_overcount=True))
    t = torch.from_numpy
    _, d1, c1 = tfused.mgm_solve_fused(
        t(u), t(v), None, t(s_lo), t(s_hi),
        sides=tuple((g, 0, L - 1) for g, _, _ in sides), L=L, ndir=ndir,
        mgm=mgm, p1=p1, p2=p2, mode="ad", trunc_dist=float("inf"),
        fix_overcount=True, use_fh=fh, lo_px=t(lo), hi_px=t(hi))
    d1, c1 = d1.numpy(), c1.numpy()
    if mgm == 1:
        assert_bitwise(d1, d0)
        assert_bitwise(c1, c0)
        return
    np.testing.assert_array_equal(np.isfinite(c1), np.isfinite(c0))
    scale = max(1.0, np.abs(S0[np.isfinite(S0)]).max())
    np.testing.assert_allclose(c1, c0, atol=3e-5 * scale, rtol=1e-5,
                               equal_nan=True)
    for n, y, x in np.argwhere(d0 != d1):
        la, lb = int(d0[n, y, x]) - sides[n][0], int(d1[n, y, x]) - sides[n][0]
        assert abs(S0[n, y, x, la] - S0[n, y, x, lb]) <= 3e-5 * scale


@pytest.mark.parametrize("ndir", [1, 4])
def test_assemble_swta_matches(rng, ndir):
    """The S assembly against mgm_tpu's with per-pixel CC and S
    windows: outside the CC window NaN at ndir 1 (0 * inf), -inf
    otherwise, then +inf outside the S window; bitwise."""
    N, H, W, L = 2, 5, 7, 9
    lsum = rng.uniform(-50, 50, (N, H, W, L)).astype(np.float32)
    lo, hi = _pp_windows(rng, N, H, W, L)
    s_lo, s_hi = np.maximum(lo - 1, 0), np.minimum(hi + 1, L - 1)
    sides = ((-3, 0, L - 1), (-5, 0, L - 1))
    t = torch.from_numpy
    got = tfused.assemble_swta(t(lsum), t(s_lo), t(s_hi), sides=sides, L=L,
                               ndir=ndir, fix_overcount=True, lo_px=t(lo),
                               hi_px=t(hi))
    want = jfused.assemble_swta(
        jnp.asarray(lsum), jnp.asarray(s_lo), jnp.asarray(s_hi),
        sides=sides, L=L, ndir=ndir, fix_overcount=True,
        lo_px=jnp.asarray(lo), hi_px=jnp.asarray(hi))
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), np.asarray(w))
    assert np.isnan(got[0].numpy()).any() == (ndir == 1)
