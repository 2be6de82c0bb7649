"""Row sharding of the port's stereo pipeline (mgm_tpu_torch.parallel)
against its unsharded run, and against mgm_tpu: the fused branch's
recursion through K4 below, and the dense mesh path (NCC, the knight
passes of ndir > 8: K5 on a band, parallel/halo.py, whose recursion
tests/test_torch_halo.py holds) through the whole pipeline in
test_pipeline_mesh_dense and test_mesh_refuses_the_dense_path.

The sharded recursion is the plain version of K4
(cuda_fused.fused_block_plain) stepped by parallel/fused_shard.py over
an in-process mesh of CPU ranks; it must equal the plain unsharded K1
bitwise, volume plane by plane, on the five mechanisms of
tests/test_sharding.py's test_sharded_fused_pipeline at its 21x30
shape (the A/B stagger with vfit and a median, census + FH at TSGM 3,
per-pixel windows, the V group at ndir 8, the parity group at ndir 8
TSGM 4) over 2 ranks (11 + 10 rows), and over 3 ranks on rows that 3
does not divide.  The whole pipeline, compute_disparity(mesh=...), must
equal the port's unsharded compute_disparity in every key, bitwise.

mgm_tpu enters through its unsharded output: its own tests hold its
sharded pipeline bitwise against that (tests/test_sharding.py), and
its fused_block in interpret mode costs minutes of XLA compile a case
(tests/test_sharding.py:157-161), so it is not run here.  The mgm_tpu
case runs at TSGM 1, where the port and mgm_tpu agree bitwise in every
key (tests/test_torch_stereo.py).

The `cuda` case holds K4 against its plain version on the card, counts
one device launch a K4 call, and holds the ranks on their own streams
against the ranks on one stream.  This file imports mgm_tpu only inside
the mgm_tpu case, so the rest runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_shard.py
"""
import numpy as np
import pytest
import torch

from mgm_tpu_torch import MGMConfig, compute_disparity
from mgm_tpu_torch import stereo
from mgm_tpu_torch.ops import cuda_fused, fused
from mgm_tpu_torch.parallel import make_mesh, sharded_fused_planes
from mgm_tpu_torch.parallel.fused_shard import BLOCK

from test_torch_kernels import assert_bitwise

H, W = 21, 30
BASE = dict(dmin=-6, dmax=2, test_lr=True)
# test_sharding.py:166-188's five mechanisms
MECHANISMS = {
    "ab_vfit_median": (dict(ndir=4, mgm=2, refinement="vfit",
                            median_radius=1), False),
    "census_fh": (dict(ndir=4, mgm=3, distance="census", prefilter="census",
                       use_trunc_linear=True, p1=2, p2=100), False),
    "per_pixel": (dict(ndir=4, mgm=2), True),
    "v_group": (dict(ndir=8, mgm=2), False),
    "parity_group": (dict(ndir=8, mgm=4), False),
}


@pytest.fixture
def pair():
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 50, (H, W, 1)).astype(np.float32)
    v = np.roll(u, 3, axis=1) + rng.normal(0, 1, (H, W, 1)).astype(
        np.float32)
    return u, v


def _windows(rows=H, seed=1):
    rng = np.random.default_rng(seed)
    lo = (BASE["dmin"] + 3 * rng.random((rows, W))).astype(np.float32)
    return dict(dmin_img=lo, dmax_img=lo + 5)


def _inputs(cfg, u, v, device, win=None):
    """The fused solve's images, weights and windows as K1 takes them
    (what compute_disparity hands mgm_solve_fused), on `device`."""
    C = u.shape[-1]
    L = cfg.dmax - cfg.dmin + 1
    u_t, v_t = (stereo._scrub(a, device) for a in (u, v))
    w8 = stereo._weights((u_t, v_t), cfg)
    u_p, v_p = (stereo._preprocess(a, cfg) for a in (u_t, v_t))
    lefts, rights = fused.side_images(u_p[None], v_p[None], nsides=2,
                                      mode=cfg.distance)
    kw = dict(sides=((cfg.dmin, 0, L - 1), (-cfg.dmax, 0, L - 1)), L=L,
              groups=fused.split_passes(cfg.ndir, cfg.mgm)[0], mgm=cfg.mgm,
              p1=cfg.p1 * C, p2=cfg.p2 * C, mode=cfg.distance,
              tmax=cfg.trunc_dist * u_p.shape[-1],
              kappa=-float(cfg.ndir - 1), use_fh=cfg.use_trunc_linear,
              w8=w8)
    if win is not None:
        flo, fhi = stereo._pixel_windows(win["dmin_img"], win["dmax_img"],
                                         cfg, *u.shape[:2], device)
        lo, hi, _, _ = stereo._pp_expand(flo, fhi, n_sides=2,
                                         gmin_l=cfg.dmin, gmin_r=-cfg.dmax,
                                         dmin=cfg.dmin, dmax=cfg.dmax)
        kw.update(lo_px=lo, hi_px=hi, fh_restrict=cfg.use_trunc_linear)
    return lefts, rights, kw


def _sharded_against_unsharded(cfg, u, v, devices, win=None, kernel=None,
                               block=BLOCK):
    """The sharded volume (K4 or `kernel` over `devices`, blocks of
    `block` steps) against the unsharded one (K1 plain or K1 on the
    first device), row band by row band."""
    lefts, rights, kw = _inputs(cfg, u, v, devices[0], win)
    plain = devices[0].type == "cpu"
    want, ns = fused.fused_planes(
        lefts, rights, wavefront=(cuda_fused.fused_wavefront_plain if plain
                                  else cuda_fused.fused_wavefront), **kw)
    bands, ns2 = sharded_fused_planes(lefts, rights,
                                      mesh=make_mesh(devices=devices),
                                      kernel=kernel, block=block, **kw)
    assert ns2 == ns and sorted(bands) == list(range(len(devices)))
    rows = 0
    for k, (r0, vol) in sorted(bands.items()):
        assert r0 == rows
        assert_bitwise(vol.cpu().numpy(),
                       want[:, r0:r0 + vol.shape[1]].cpu().numpy())
        rows += vol.shape[1]
    assert rows == u.shape[0]


# blocks of 4 steps: aprons of 4 rows inside the 11-row bands, so the
# lockstep groups refresh them many times (at 32, B is the band's 11
# rows and an apron reaches the image's edge)
@pytest.mark.parametrize("block", [32, 4])
@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_sharded_recursion_matches_k1(pair, name, block):
    over, pp = MECHANISMS[name]
    cfg = MGMConfig(**BASE, **over)
    _sharded_against_unsharded(cfg, *pair, [torch.device("cpu")] * 2,
                               _windows() if pp else None, block=block)


# 22 rows over 3 ranks: 8 + 8 + 6; A/B with weights, A/B + V, and A/B +
# PA/PB; blocks of 4 steps: the A/B stagger's two-slot halo ring wraps
# 6-13 times, and the lockstep groups' 4-row aprons refresh every 4 steps
AB_WEIGHTS, V_GROUP, ALL_GROUPS = (dict(ndir=4, mgm=3, a_p2=0.5),
                                  dict(ndir=8, mgm=2), dict(ndir=8, mgm=4))


@pytest.mark.parametrize("over,block", [
    (AB_WEIGHTS, BLOCK), (ALL_GROUPS, BLOCK), (V_GROUP, BLOCK),
    (AB_WEIGHTS, 4), (V_GROUP, 4), (ALL_GROUPS, 4)],
    ids=["ab_weights", "all_groups", "v_group", "ab_weights_block4",
         "v_group_block4", "all_groups_block4"])
def test_sharded_recursion_ragged_rows(over, block):
    rng = np.random.default_rng(2)
    u = rng.uniform(0, 50, (22, W, 3)).astype(np.float32)
    v = np.roll(u, 2, axis=1)
    cfg = MGMConfig(**BASE, **over)
    _sharded_against_unsharded(cfg, u, v, [torch.device("cpu")] * 3,
                               block=block)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert_bitwise(got[k], want[k])


@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_pipeline_mesh_matches_unsharded(pair, name):
    over, pp = MECHANISMS[name]
    cfg = MGMConfig(**BASE, **over)
    win = _windows() if pp else {}
    want = compute_disparity(*pair, cfg, device="cpu", **win)
    got = compute_disparity(*pair, cfg, **win,
                            mesh=make_mesh(devices=["cpu"] * 2))
    _assert_same(got, want)


# ragged rows over 3 and 4 ranks, with TSGM_ITER (the S windows tighten
# on the gathered maps), weights, per-pixel windows and TSGM_DEBUG
@pytest.mark.parametrize("n,over,pp", [
    (3, dict(ndir=8, mgm=3, a_p2=0.5, iterations=2, refinement="vfit"),
     False),
    (4, dict(ndir=6, mgm=4, median_radius=1), True),
    (3, dict(ndir=2, mgm=2, debug=True, iterations=2), False),
], ids=["iter_weights_3", "pp_parity_4", "debug_3"])
def test_pipeline_mesh_ragged(pair, tmp_path, monkeypatch, n, over, pp):
    monkeypatch.setattr(stereo, "ENERGY_DUMP", str(tmp_path / "e.tif"))
    cfg = MGMConfig(**BASE, **over)
    win = _windows() if pp else {}
    want = compute_disparity(*pair, cfg, device="cpu", **win)
    got = compute_disparity(*pair, cfg, **win,
                            mesh=make_mesh(devices=["cpu"] * n))
    _assert_same(got, want)


def test_tiled_runner_over_a_mesh(pair):
    """runner.tiled_disparity(mesh=...) solves tile by tile over the
    ranks: equal to its unsharded batch = 1 run."""
    from mgm_tpu_torch.runner import tiled_disparity

    u, v = pair
    cfg = MGMConfig(**BASE, ndir=4, mgm=2)
    kw = dict(tile=16, margin=4)
    want = tiled_disparity(u, v, cfg, batch=1, device="cpu", **kw)
    got = tiled_disparity(u, v, cfg, mesh=make_mesh(devices=["cpu"] * 2),
                          **kw)
    assert got["tiles_solved"] == want["tiles_solved"] == 4
    for k in ("disp", "cost"):
        assert_bitwise(got[k], want[k])


def test_tiled_runner_over_a_mesh_dense():
    """The tiled runner over 3 ranks with NCC (the dense mesh path tile by
    tile): equal to its unsharded batch = 1 run."""
    from mgm_tpu_torch.runner import tiled_disparity

    rng = np.random.default_rng(9)
    u = rng.uniform(0, 50, (H, W, 3)).astype(np.float32)
    v = np.roll(u, 3, axis=1)
    cfg = MGMConfig(**BASE, distance="ncc", ndir=8, mgm=2)
    kw = dict(tile=16, margin=4)
    want = tiled_disparity(u, v, cfg, batch=1, device="cpu", **kw)
    got = tiled_disparity(u, v, cfg, mesh=make_mesh(devices=["cpu"] * 3),
                          **kw)
    assert got["tiles_solved"] == want["tiles_solved"] == 4
    for k in ("disp", "cost"):
        assert_bitwise(got[k], want[k])


def test_pipeline_mesh_matches_mgm_tpu(monkeypatch):
    """cfg1's settings at TSGM 1 over 2 ranks against mgm_tpu's
    unsharded compute_disparity: bitwise in every key."""
    from mgm_tpu.config import MGMConfig as JaxConfig
    from mgm_tpu.stereo import compute_disparity as jax_disparity
    from mgm_tpu_torch.config import from_jax
    from mgm_tpu_torch.synthetic import synthetic_pair

    monkeypatch.setenv("MGM_TPU_PACKOUT", "0")
    u, v, _ = synthetic_pair(24, 40, -8, 4, seed=3)
    cfg = JaxConfig(dmin=-120, dmax=30, ndir=4, mgm=1, distance="ad", p1=8,
                    p2=32, test_lr=True)
    want = jax_disparity(u, v, cfg)
    got = compute_disparity(u, v, from_jax(cfg),
                            mesh=make_mesh(devices=["cpu"] * 2))
    _assert_same(got, want)


# the configurations that the fused rows' runner leaves to the dense mesh
# path (parallel/halo.py: K5 on a band): once refused, now each output
# bitwise the unsharded run's
@pytest.mark.parametrize("over", [dict(distance="ncc"), dict(ndir=16)],
                         ids=["ncc", "ndir16"])
def test_mesh_refuses_the_dense_path(pair, over):
    cfg = MGMConfig(**BASE, **over)
    want = compute_disparity(*pair, cfg, device="cpu")
    got = compute_disparity(*pair, cfg, mesh=make_mesh(devices=["cpu"] * 2))
    _assert_same(got, want)


def test_mesh_shapes_and_refusals():
    """The band of a rank, also where the last rank holds no row (9 rows
    over 4 ranks: 3, 3, 3 and 0), and the dense entry points on such a
    mesh (once stubs): equal to their unsharded counterparts."""
    from mgm_tpu_torch.mrf import solve_mrf
    from mgm_tpu_torch.parallel import sharded_solve, solve_tiled
    from mgm_tpu_torch.solver import mgm_solve

    mesh = make_mesh(devices=["cpu"] * 4)
    assert (mesh.size, mesh.band(21), mesh.writes) == (4, 6, True)
    assert mesh.band(9) == 3
    assert [mesh.rows(9, k) for k in range(4)] == [(0, 3), (3, 6), (6, 9),
                                                   (9, 9)]
    rng = np.random.default_rng(6)
    unary = rng.uniform(0, 30, (9, 11, 5)).astype(np.float32)
    cc = torch.from_numpy(unary)[None]
    disp, _ = solve_tiled(mesh, cc, p1=8.0, p2=32.0, ndir=8, mgm=2)
    assert_bitwise(disp[0].numpy(), solve_mrf(unary, device="cpu"))
    zeros = torch.zeros((1, 9, 11), dtype=torch.int32)
    args = (cc, None, zeros, zeros + 4, zeros, zeros + 4,
            torch.zeros(1, dtype=torch.int32))
    kw = dict(p1=8.0, p2=32.0, ndir=16, mgm=2, use_fh=False,
              use_weights=False, per_pixel=False, fix_overcount=True)
    for got, want in zip(sharded_solve(mesh, *args, **kw),
                         mgm_solve(*args, **kw)):
        assert_bitwise(got.numpy(), want.numpy())
    # the fused rows' runner over the same mesh
    u = rng.uniform(0, 50, (9, 30, 1)).astype(np.float32)
    v = np.roll(u, 3, axis=1)
    cfg = MGMConfig(**BASE, ndir=8, mgm=2)
    _assert_same(compute_disparity(u, v, cfg, mesh=mesh),
                 compute_disparity(u, v, cfg, device="cpu"))


# the dense branch (NCC) and the leftover passes of ndir > 8 over the
# mesh: ncc with windows and refinement, full_16dir (knight passes
# through K8 volumes of each band), ndir 10 and 12, ncc at TSGM_ITER 2,
# ncc with per-pixel windows and FH; H that does and does not divide n
DENSE = {
    "ncc_windows": (dict(distance="ncc", census_ncc_win=5, ndir=8, mgm=2,
                         refinement="vfit", median_radius=1), 13, 2, False),
    "ncc_divides": (dict(distance="ncc", ndir=8, mgm=2, refinement="vfit"),
                    12, 4, False),
    "full_16dir": (dict(ndir=16, mgm=4, distance="census",
                        prefilter="census", use_trunc_linear=True,
                        refinement="vfit"), 13, 3, False),
    "ndir10": (dict(ndir=10, mgm=2), 9, 4, False),
    "ndir12_fh": (dict(ndir=12, mgm=3, use_trunc_linear=True), 14, 4,
                  False),
    "ncc_iter2": (dict(distance="ncc", ndir=8, mgm=2, iterations=2,
                       refinement="vfit"), 12, 3, False),
    "ncc_per_pixel": (dict(distance="ncc", ndir=4, mgm=2,
                           use_trunc_linear=True, refinement="vfit"), 13, 2,
                      True),
    "ndir16_per_pixel": (dict(ndir=16, mgm=2), 12, 3, True),
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_pipeline_mesh_dense(name):
    over, rows, n, pp = DENSE[name]
    cfg = MGMConfig(**BASE, **over)
    rng = np.random.default_rng(8)
    ch = 3 if cfg.distance == "ncc" else 1
    u = rng.uniform(0, 50, (rows, 21, ch)).astype(np.float32)
    v = np.roll(u, 3, axis=1) + rng.normal(0, 1, u.shape).astype(np.float32)
    win = _windows(rows) if pp else {}
    if pp:
        win = {k: a[:, :21] for k, a in win.items()}
    want = compute_disparity(u, v, cfg, device="cpu", **win)
    got = compute_disparity(u, v, cfg, **win,
                            mesh=make_mesh(devices=["cpu"] * n))
    _assert_same(got, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# K4 against its plain version on a 40-row strip over 2 ranks of the
# card, the ranks on their own streams against the ranks on the one
# current stream, one device launch a K4 call, and K4 sharded against K1
# unsharded, for each group
@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_k4_matches_plain_on_the_card(cuda, name, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    over, pp = MECHANISMS[name]
    cfg = MGMConfig(**BASE, **over)
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 50, (40, 64, 3)).astype(np.float32)
    v = np.roll(u, 3, axis=1)
    win = _windows(40) if pp else None
    if win is not None:
        win = {k: np.tile(a, (1, 3))[:, :64] for k, a in win.items()}
    lefts, rights, kw = _inputs(cfg, u, v, cuda, win)
    mesh = make_mesh(devices=[cuda] * 2)
    torch.cuda.synchronize()
    cuda_fused.fused_block.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got, _ = sharded_fused_planes(lefts, rights, mesh=mesh, **kw)
        torch.cuda.synchronize()
    device = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "fused_block_cluster" in e.name)
    assert device == cuda_fused.fused_block.launches > 0
    want, _ = sharded_fused_planes(lefts, rights, mesh=mesh,
                                   kernel=cuda_fused.fused_block_plain,
                                   **kw)
    one = make_mesh(devices=[cuda] * 2)
    monkeypatch.setattr(one, "stream", lambda k: None)
    same, _ = sharded_fused_planes(lefts, rights, mesh=one, **kw)
    torch.cuda.synchronize()
    for k in got:
        assert_bitwise(got[k][1].cpu().numpy(), want[k][1].cpu().numpy())
        assert_bitwise(got[k][1].cpu().numpy(), same[k][1].cpu().numpy())
    _sharded_against_unsharded(cfg, u, v, [cuda] * 3, win)
    _sharded_against_unsharded(cfg, u, v, [cuda] * 3, win, block=4)
