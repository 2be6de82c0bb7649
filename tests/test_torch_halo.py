"""The dense recursion row-sharded over a mesh (mgm_tpu_torch.parallel.halo,
K5 on a band) against the port's unsharded run, and against mgm_tpu.

On the CPU, K5 on a band is its plain version (wavefront_band_plain),
stepped by parallel/halo.py over in-process CPU ranks; the sharded sum
must equal ops.aggregate's (K5's plain version, which
tests/test_torch_aggregate.py holds against mgm_tpu) bitwise: every
ndir 4/8/16 x TSGM 1-4 on ragged rows (13 rows over 4 ranks: 4, 4, 4
and 1; 7 columns: 2, 2, 2 and 1), weighted FH with and without the
window restriction, blocks of 4 fronts (the halo ring wraps many times)
and H = 9 over 4 ranks (the last rank holds no row).  sharded_solve
must equal solver.mgm_solve and solve_tiled mrf.solve_mrf.

mgm_tpu enters in three calls, each an XLA compile of seconds: its
halo_aggregate over 4 virtual devices on a ragged problem at TSGM 2
(bitwise: the same homogeneous groups, summed in the same order), its
aggregate(backend="xla", hpad=) against the port's aggregate(hpad=) at
TSGM 2 (bitwise), and its unsharded compute_disparity against the port's
ncc over a mesh (test_presets_match_mgm_tpu's rules).  The `cuda` case
holds K5 on a band against its plain version on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_halo.py
"""
import numpy as np
import pytest
import torch

from mgm_tpu_torch.mrf import solve_mrf
from mgm_tpu_torch.ops import wavefront as wf
from mgm_tpu_torch.ops.aggregate import aggregate
from mgm_tpu_torch.parallel import (halo_aggregate, make_mesh, sharded_solve,
                                    solve_tiled)
from mgm_tpu_torch.parallel.halo import (aggregate_bands, band_volumes,
                                         cutter)
from mgm_tpu_torch.solver import mgm_solve

from test_torch_kernels import assert_bitwise

P1, P2 = 3.0, 11.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volume(seed, N, H, W, L, windows=False):
    """Random costs, +inf outside random label windows when `windows`;
    returns (cc, lo, hi)."""
    rng = np.random.default_rng(seed)
    cc = torch.from_numpy(rng.uniform(0, 20, (N, H, W, L)).astype(np.float32))
    lo = torch.from_numpy(rng.integers(0, 3, (N, H, W)).astype(np.int32))
    hi = lo + L - 3
    if windows:
        lab = torch.arange(L)
        cc = torch.where((lab >= lo[..., None]) & (lab <= hi[..., None]), cc,
                         float("inf"))
    return cc, lo, hi


def _weights(seed, N, H, W):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([0.25, 1.0, 2.0], (N, H, W, 8))
                            .astype(np.float32))


def _sharded(cc, n, *, w8=None, lo=None, hi=None, block=None, **kw):
    """aggregate_bands over n CPU ranks, the row bands gathered."""
    N, H, W, L = cc.shape
    mesh = make_mesh(devices=["cpu"] * n)
    bands = band_volumes(mesh, H, W, cutter(cc), w8=w8, lo=lo, hi=hi)
    return mesh.gather_rows(aggregate_bands(mesh, H, W, bands, p1=P1, p2=P2,
                                            block=block, **kw), H)


# every pass schedule of K5's groups: axis, diagonal and knight passes,
# row- and column-major, both flow signs, slope 1 and 2
@pytest.mark.parametrize("mgm", [1, 2, 3, 4])
@pytest.mark.parametrize("ndir", [4, 8, 16])
def test_halo_aggregate_matches_aggregate(ndir, mgm):
    cc, _, _ = _volume(ndir * 10 + mgm, 2, 13, 7, 6)
    want = aggregate(cc, p1=P1, p2=P2, ndir=ndir, mgm=mgm)
    got = halo_aggregate(make_mesh(devices=["cpu"] * 4), cc, p1=P1, p2=P2,
                         ndir=ndir, mgm=mgm)
    assert_bitwise(got.numpy(), want.numpy())


# blocks of 4 fronts: the two-slot halo ring wraps; weighted FH with and
# without the window restriction (mgm 3: restricted; mgm 2 unweighted:
# aggregate's full-axis rule); H = 9 over 4 ranks (3, 3, 3 and 0 rows)
@pytest.mark.parametrize("shape,n,kw", [
    ((2, 13, 7, 6), 4, dict(ndir=16, mgm=2)),
    ((1, 11, 10, 5), 3, dict(ndir=8, mgm=3, use_fh=True, use_weights=True)),
    ((2, 10, 9, 6), 2, dict(ndir=8, mgm=3, use_fh=True, use_weights=True,
                            fh_restrict=True)),
    ((2, 10, 9, 6), 3, dict(ndir=4, mgm=2, use_fh=True, fh_restrict=True)),
    ((2, 9, 11, 5), 4, dict(ndir=16, mgm=4)),
], ids=["knights", "weighted_fh", "weighted_fh_windows", "fh_mgm2_windows",
        "nine_rows_over_four"])
def test_halo_blocks_of_four(shape, n, kw):
    cc, lo, hi = _volume(7, *shape, windows=kw.get("fh_restrict", False))
    w8 = _weights(8, *shape[:3]) if kw.get("use_weights") else None
    wins = dict(lo=lo, hi=hi) if kw.get("fh_restrict") else {}
    want = aggregate(cc, w8, p1=P1, p2=P2, **wins, **kw)
    got = _sharded(cc, n, w8=w8, block=4, **wins, **kw)
    assert_bitwise(got.numpy(), want.numpy())


@pytest.mark.parametrize("n,kw", [
    (3, dict(ndir=8, mgm=2, per_pixel=True)),
    (4, dict(ndir=16, mgm=3, use_fh=True, use_weights=True,
             per_pixel=True)),
], ids=["ndir8_3ranks", "ndir16_fh_weights_4ranks"])
def test_sharded_solve_matches_mgm_solve(n, kw):
    cc, lo, hi = _volume(3, 2, 11, 9, 7, windows=True)
    w8 = _weights(4, 2, 11, 9)
    gmin = torch.tensor([-3, 1], dtype=torch.int32)
    args = (cc, w8, lo, hi, lo + 1, hi, gmin)
    opts = dict(dict(p1=P1, p2=P2, fix_overcount=True, use_fh=False,
                     use_weights=False), **kw)
    want = mgm_solve(*args, **opts)
    got = sharded_solve(make_mesh(devices=["cpu"] * n), *args, **opts)
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), w.numpy())


@pytest.mark.parametrize("vtype", [0, 1])
def test_solve_tiled_matches_solve_mrf(vtype):
    rng = np.random.default_rng(5)
    unary = rng.uniform(0, 30, (10, 12, 6)).astype(np.float32)
    w8 = rng.choice([0.25, 1.0], (10, 12, 8)).astype(np.float32)
    want = solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w8, device="cpu")
    disp, cost = solve_tiled(make_mesh(devices=["cpu"] * 4),
                             torch.from_numpy(unary)[None],
                             torch.from_numpy(w8)[None], p1=8.0, p2=32.0,
                             ndir=8, mgm=2, use_fh=bool(vtype))
    assert disp.shape == cost.shape == (1, 10, 12)
    assert_bitwise(disp[0].numpy(), want)


def test_halo_aggregate_matches_mgm_tpu():
    """mgm_tpu's halo_aggregate over 4 virtual devices on 13 ragged rows
    at TSGM 2: bitwise (both sum homogeneous groups in one order)."""
    import jax.numpy as jnp
    from mgm_tpu.parallel import make_mesh as jax_mesh
    from mgm_tpu.parallel.halo import halo_aggregate as jax_halo

    cc, _, _ = _volume(11, 2, 13, 7, 6)
    want = jax_halo(jax_mesh(4), jnp.asarray(cc.numpy()), p1=P1, p2=P2,
                    ndir=8, mgm=2)
    got = halo_aggregate(make_mesh(devices=["cpu"] * 4), cc, p1=P1, p2=P2,
                         ndir=8, mgm=2)
    assert_bitwise(got.numpy(), np.asarray(want))


def test_aggregate_hpad_matches_mgm_tpu():
    """aggregate(hpad=) (K5's shifted border) against mgm_tpu's XLA
    aggregate(hpad=) at ndir 16 TSGM 2: 3 fake bottom rows of 12, every
    pass's real border at the true edge; bitwise."""
    import jax.numpy as jnp
    from mgm_tpu.ops.aggregate import aggregate as jax_aggregate

    cc, _, _ = _volume(12, 2, 12, 9, 5)
    want = jax_aggregate(jnp.asarray(cc.numpy()), p1=P1, p2=P2, ndir=16,
                         mgm=2, backend="xla", hpad=3)
    got = aggregate(cc, p1=P1, p2=P2, ndir=16, mgm=2, hpad=3)
    assert_bitwise(got.numpy(), np.asarray(want))


def test_ncc_mesh_matches_mgm_tpu(monkeypatch):
    """The ncc preset over 3 ranks (16 rows: 6, 6, 4) against mgm_tpu's
    unsharded compute_disparity, under test_presets_match_mgm_tpu's
    rules."""
    from mgm_tpu.models import get_preset as jax_preset
    from mgm_tpu.stereo import compute_disparity as jax_disparity
    from mgm_tpu_torch import compute_disparity
    from mgm_tpu_torch.config import from_jax
    from mgm_tpu_torch.synthetic import synthetic_pair

    from test_torch_stereo import assert_matches_mgm_tpu

    monkeypatch.setenv("MGM_TPU_PACKOUT", "0")
    u, v, _ = synthetic_pair(16, 24, -6, 3, seed=3)
    cfg = jax_preset("ncc", dmin=-6, dmax=3, test_lr=True)
    want = jax_disparity(u, v, cfg)
    got = compute_disparity(u, v, from_jax(cfg),
                            mesh=make_mesh(devices=["cpu"] * 3))
    assert_matches_mgm_tpu(cfg, want, got)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# K5 on a band against its plain version on the card: every group kind
# (axis, diagonal, knight; both flow signs, row- and column-major), SGM
# and FH, weights, the window restriction, L 6 / 49 / 151, over 2 and 4
# ranks of the card (each on its own stream), blocks of 4 and 64 fronts,
# a rank without a row; each bitwise, and one device launch a call
@pytest.mark.cuda
@pytest.mark.parametrize("L", [6, 49, 151])
@pytest.mark.parametrize("shape,n,block,kw", [
    ((2, 40, 33), 2, 64, dict(ndir=8, mgm=2)),
    ((2, 40, 33), 3, 4, dict(ndir=16, mgm=4)),
    ((1, 37, 30), 4, 64, dict(ndir=8, mgm=3, use_fh=True, use_weights=True,
                              fh_restrict=True)),
    ((2, 9, 26), 4, 4, dict(ndir=16, mgm=2, use_fh=True)),
], ids=["ncc_like_2", "all_passes_3", "weighted_fh_windows_4",
        "nine_rows_4"])
def test_k5_band_matches_plain_on_the_card(cuda, L, shape, n, block, kw):
    from torch.profiler import ProfilerActivity, profile

    cc, lo, hi = _volume(L, *shape, L,
                         windows=kw.get("fh_restrict", False))
    w8 = _weights(L + 1, *shape) if kw.get("use_weights") else None
    wins = dict(lo=lo, hi=hi) if kw.get("fh_restrict") else {}
    N, H, W = shape
    mesh = make_mesh(devices=[cuda] * n)
    dev = {k: (v.to(cuda) if v is not None else None)
           for k, v in dict(w8=w8, **wins).items()}
    bands = band_volumes(mesh, H, W, cutter(cc.to(cuda)), **dev)
    torch.cuda.synchronize()
    wf.wavefront_band.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = mesh.gather_rows(aggregate_bands(
            mesh, H, W, bands, p1=P1, p2=P2, block=block, **kw), H)
        torch.cuda.synchronize()
    device = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "wavefront_rows<true" in e.name)
    assert device == wf.wavefront_band.launches > 0
    want = mesh.gather_rows(aggregate_bands(
        mesh, H, W, bands, p1=P1, p2=P2, block=block,
        kernel=wf.wavefront_band_plain, **kw), H)
    assert_bitwise(got.cpu().numpy(), want.cpu().numpy())
    one = aggregate(cc.to(cuda), dev.get("w8"), dev.get("lo"), dev.get("hi"),
                    p1=P1, p2=P2, **kw)
    assert_bitwise(got.cpu().numpy(), one.cpu().numpy())
