"""Row sharding of the port's fused branch (mgm_tpu_torch.parallel)
against its unsharded run, and against mgm_tpu.

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

The `cuda` case holds K4 against its plain version on the card.  This
file imports mgm_tpu only inside the mgm_tpu case, so the rest runs
where the card is:

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
@pytest.mark.parametrize("block", [BLOCK, 4])
@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_sharded_recursion_matches_k1(pair, name, block):
    over, pp = MECHANISMS[name]
    cfg = MGMConfig(**BASE, **over)
    _sharded_against_unsharded(cfg, *pair, [torch.device("cpu")] * 2,
                               _windows() if pp else None, block=block)


# 22 rows over 3 ranks: 8 + 8 + 6; A/B with weights, and every group
@pytest.mark.parametrize("over", [dict(ndir=4, mgm=3, a_p2=0.5),
                                  dict(ndir=8, mgm=4)],
                         ids=["ab_weights", "all_groups"])
def test_sharded_recursion_ragged_rows(over):
    rng = np.random.default_rng(2)
    u = rng.uniform(0, 50, (22, W, 3)).astype(np.float32)
    v = np.roll(u, 2, axis=1)
    cfg = MGMConfig(**BASE, **over)
    _sharded_against_unsharded(cfg, u, v, [torch.device("cpu")] * 3)


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


@pytest.mark.parametrize("over", [dict(distance="ncc"), dict(ndir=16)],
                         ids=["ncc", "ndir16"])
def test_mesh_refuses_the_dense_path(pair, over):
    cfg = MGMConfig(**BASE, **over)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10a"):
        compute_disparity(*pair, cfg, mesh=make_mesh(devices=["cpu"] * 2))


def test_mesh_shapes_and_refusals():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert (mesh.size, mesh.band(21), mesh.writes) == (4, 6, True)
    with pytest.raises(ValueError, match="without a row"):
        mesh.band(9)      # 3 rows a rank leave rank 3 none
    from mgm_tpu_torch.parallel import sharded_solve, solve_tiled
    for fn in (sharded_solve, solve_tiled):
        with pytest.raises(NotImplementedError, match="item 10a"):
            fn(mesh)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# K4 against its plain version on a 40-row strip over 2 ranks of the
# card, and K4 sharded against K1 unsharded, for each group
@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_k4_matches_plain_on_the_card(cuda, name):
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
    got, _ = sharded_fused_planes(lefts, rights, mesh=mesh, **kw)
    want, _ = sharded_fused_planes(lefts, rights, mesh=mesh,
                                   kernel=cuda_fused.fused_block_plain,
                                   **kw)
    torch.cuda.synchronize()
    for k in got:
        assert_bitwise(got[k][1].cpu().numpy(), want[k][1].cpu().numpy())
    _sharded_against_unsharded(cfg, u, v, [cuda] * 3, win)
