"""The port's dense cost volume and aggregation against mgm_tpu's.

mgm_tpu runs its XLA path here (the CPU): `aggregate(backend="xla")`
and the jitted `build_cost_volume`.  The port runs the plain PyTorch
versions of K6/K5/K7, in the order of operations of the TPU kernel
pallas_wavefront._front_update.  Tolerances:
  - mgm 1: bitwise (min-plus over float32 with no division);
  - otherwise the tolerance tests/test_pallas.py uses between the TPU
    kernel and XLA: equal inf masks and signs, finite values within
    atol 2e-3, rtol 1e-6 (XLA divides by 3 and sums mixed mgm-4 pass
    groups in another order);
  - pointwise cost volumes: bitwise; NCC: bitwise against mgm_tpu's
    _ncc_costs run op by op (eagerly), and within atol 2e-3 of the
    jitted builder, whose fusions round differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgm_tpu.ops import aggregate as jagg
from mgm_tpu.ops import cost as jcost
from mgm_tpu_torch.ops import aggregate as tagg
from mgm_tpu_torch.ops import cost as tcost

from test_torch_kernels import assert_bitwise


def make_problem(rng, N=2, H=9, W=11, L=6, per_pixel=False, weighted=False):
    """tests/test_pallas.py's problem, as numpy arrays."""
    lo = np.zeros((N, H, W), np.int32)
    hi = np.full((N, H, W), L - 1, np.int32)
    if per_pixel:
        lo = rng.integers(0, L - 2, (N, H, W)).astype(np.int32)
        hi = (lo + rng.integers(1, L - 1, (N, H, W))).clip(max=L - 1)
        hi = hi.astype(np.int32)
    cc = rng.uniform(0, 50, (N, H, W, L)).astype(np.float32)
    inw = (np.arange(L) >= lo[..., None]) & (np.arange(L) <= hi[..., None])
    cc = np.where(inw, cc, np.inf).astype(np.float32)
    w8 = None
    if weighted:
        w8 = np.where(rng.random((N, H, W, 8)) < 0.5, 0.25,
                      1.0).astype(np.float32)
    return cc, w8, lo, hi


def check_close(a, b):
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    assert np.array_equal(np.sign(a[~fin]), np.sign(b[~fin]))
    np.testing.assert_allclose(a[fin], b[fin], atol=2e-3, rtol=1e-6)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (aggregate keywords, problem keywords)
CASES = {
    "sgm_mgm1": (dict(ndir=8, mgm=1), {}),
    "sgm_mgm2": (dict(ndir=8, mgm=2), {}),
    "sgm_mgm4": (dict(ndir=8, mgm=4), {}),
    "fh_mgm3": (dict(ndir=8, mgm=3, use_fh=True, p1=5.0, p2=19.0), {}),
    "weighted_mgm2": (dict(ndir=8, mgm=2, use_weights=True),
                      dict(weighted=True)),
    "weighted_fh_windows": (dict(ndir=8, mgm=3, use_fh=True,
                                 use_weights=True, fh_restrict=True, p1=5.0,
                                 p2=19.0),
                            dict(weighted=True, per_pixel=True)),
    "knight_ndir16": (dict(ndir=16, mgm=4), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_aggregate_matches_jax(name):
    kw, pk = CASES[name]
    kw = dict(dict(p1=8.0, p2=32.0), **kw)
    cc, w8, lo, hi = make_problem(np.random.default_rng(0), **pk)
    want = np.asarray(jagg.aggregate(_j(cc), _j(w8), _j(lo), _j(hi),
                                     backend="xla", **kw))
    got = tagg.aggregate(_t(cc), _t(w8), _t(lo), _t(hi), **kw).numpy()
    if kw["mgm"] == 1:
        assert_bitwise(got, want)
    else:
        check_close(want, got)


def test_pass_groups_are_the_accelerator_groups():
    for ndir in (1, 2, 4, 8, 16):
        for mgm in (1, 2, 3, 4):
            assert tagg._pass_groups(ndir, mgm) == jagg._pass_groups(
                ndir, mgm, homogeneous=True)
    assert tagg.PASS_TABLE == tuple(
        tagg.PassSpec(**vars(s)) for s in jagg.PASS_TABLE)


def test_group_plan_slopes():
    """Slope 2 exactly where the NE offset is active (aggregate.py:408)."""
    for ndir, mgm in ((8, 1), (8, 2), (8, 3), (8, 4), (16, 4)):
        for g in tagg._pass_groups(ndir, mgm):
            plan = tagg.group_plan(g, 9, 11, mgm)
            assert plan.slope == (2 if 3 in plan.offs else 1)
            assert plan.knight == (g[0] >= 8)


def test_aggregate_refuses_mesh_padding():
    cc, _, lo, hi = make_problem(np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tagg.aggregate(_t(cc), None, _t(lo), _t(hi), p1=8.0, p2=32.0,
                       ndir=4, mgm=2, hpad=1)


def _images(rng, H=10, W=16, C=3):
    return (rng.integers(0, 255, (H, W, C)).astype(np.float32),
            rng.integers(0, 255, (H, W, C)).astype(np.float32))


@pytest.mark.parametrize("distance", ["ad", "sd", "btad", "btsd"])
def test_pointwise_volumes_bitwise(distance):
    rng = np.random.default_rng(1)
    u, v = _images(rng)
    L, gmin = 9, -5
    lo = rng.integers(0, 4, u.shape[:2]).astype(np.int32)
    hi = (lo + 4).astype(np.int32)
    kw = dict(distance=distance, L=L, trunc_dist=60.0)
    want = np.asarray(jcost.build_cost_volume(
        *map(jnp.asarray, (u, v, lo, hi)), gmin, backend="xla", **kw))
    got = tcost.build_cost_volume(*map(torch.from_numpy, (u, v, lo, hi)),
                                  gmin, **kw).numpy()
    assert_bitwise(got, want)


def test_census_costs_bitwise():
    rng = np.random.default_rng(2)
    cu, cv = (rng.integers(0, 2**32, (6, 12, 2), dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    want = np.asarray(jcost.pointwise_costs(jnp.asarray(cu), jnp.asarray(cv),
                                            -3, 7, "census", 5,
                                            backend="xla"))
    got = tcost.pointwise_costs(torch.from_numpy(cu.astype(np.int64)),
                                torch.from_numpy(cv.astype(np.int64)), -3, 7,
                                "census", 5).numpy()
    assert_bitwise(got, want)


def test_ncc_volume():
    rng = np.random.default_rng(3)
    u, v = _images(rng, H=12, W=20)
    L, gmin = 9, -5
    got = tcost._ncc_costs(torch.from_numpy(u), torch.from_numpy(v), gmin,
                           L, 5).numpy()
    eager = np.asarray(jcost._ncc_costs(jnp.asarray(u), jnp.asarray(v), gmin,
                                        L, 5))
    assert_bitwise(got, eager)
    lo = np.zeros(u.shape[:2], np.int32)
    hi = np.full(u.shape[:2], L - 1, np.int32)
    kw = dict(distance="ncc", L=L, trunc_dist=float("inf"), ncc_win=5)
    want = np.asarray(jcost.build_cost_volume(
        *map(jnp.asarray, (u, v, lo, hi)), gmin, backend="xla", **kw))
    got = tcost.build_cost_volume(*map(torch.from_numpy, (u, v, lo, hi)),
                                  gmin, **kw).numpy()
    check_close(want, got)


def test_pointwise_off_the_cpu_needs_k8():
    meta = torch.empty((4, 6, 1), device="meta")
    with pytest.raises(NotImplementedError, match="K8.*ROADMAP"):
        tcost.pointwise_costs(meta, meta, 0, 3, "ad", 3)
