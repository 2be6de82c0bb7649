"""Bitwise equality of the port's prep and post ops with mgm_tpu's
(mgm_tpu's run eagerly here, op by op, as the port's do)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgm_tpu.ops import census as jcensus
from mgm_tpu.ops import post as jpost
from mgm_tpu.ops import prefilter as jpre
from mgm_tpu.ops.weights import compute_weights as j_weights
from mgm_tpu_torch.ops import census as tcensus
from mgm_tpu_torch.ops import post as tpost
from mgm_tpu_torch.ops import prefilter as tpre
from mgm_tpu_torch.ops.common import shift_edge, shift_fill
from mgm_tpu_torch.ops.weights import compute_weights as t_weights

from test_torch_kernels import assert_bitwise


def _with_nans(rng, a, frac):
    a = a.copy()
    a[rng.random(a.shape) < frac] = np.nan
    return a


@pytest.mark.parametrize("off,axis", [(1, 0), (-2, 1), (3, -1), (0, 0)])
def test_shifts(rng, off, axis):
    from mgm_tpu.ops.common import shift_edge as je, shift_fill as jf
    a = rng.normal(size=(5, 7)).astype(np.float32)
    assert_bitwise(shift_fill(torch.from_numpy(a), off, axis, np.inf).numpy(),
                   jf(jnp.asarray(a), off, axis, np.inf))
    assert_bitwise(shift_edge(torch.from_numpy(a), off, axis).numpy(),
                   je(jnp.asarray(a), off, axis))


@pytest.mark.parametrize("a_p,thresh,nans", [(0.5, 5.0, False),
                                             (2.0, 3.3, False),
                                             (0.25, 7.0, True)])
def test_compute_weights(rng, a_p, thresh, nans):
    img = rng.uniform(0, 20, (9, 11, 3)).astype(np.float32)
    img[2:4, 3:6] = 7.0  # flat patch: deltas of exactly 0
    if nans:
        img = _with_nans(rng, img, 0.1)
    got = t_weights(torch.from_numpy(img), a_p, thresh).numpy()
    want = np.asarray(j_weights(jnp.asarray(img), a_p, thresh))
    assert_bitwise(got, want)
    assert (got != 1.0).any() and (got == 1.0).any()


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_median_filter(rng, radius):
    x = _with_nans(rng, rng.normal(0, 10, (2, 9, 13)).astype(np.float32), 0.3)
    x[0, :3, :3] = np.nan  # an all-NaN window keeps its value
    got = tpost.median_filter(torch.from_numpy(x), radius=radius).numpy()
    assert_bitwise(got, jpost.median_filter(jnp.asarray(x), radius=radius))


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_leftright_test(rng, tau):
    H, W = 9, 23
    # integers, half-integers (C round(): half away from zero) and NaNs
    dl = rng.integers(-8, 9, (H, W)).astype(np.float32)
    dl += np.where(rng.random((H, W)) < 0.3, 0.5, 0.0).astype(np.float32)
    dl = _with_nans(rng, dl, 0.1)
    dr = _with_nans(rng, -dl + rng.integers(-1, 2, (H, W)).astype(np.float32),
                    0.1)
    got = tpost.leftright_test(torch.from_numpy(dl), torch.from_numpy(dr),
                               tau).numpy()
    want = jpost.leftright_test(jnp.asarray(dl), jnp.asarray(dr),
                                jnp.float32(tau))
    assert_bitwise(got, want)
    assert np.isnan(got).sum() > np.isnan(dl).sum()  # the test did reject


def test_backflow(rng):
    H, W = 9, 23
    disp = rng.uniform(-30, 30, (H, W)).astype(np.float32)
    disp = _with_nans(rng, disp, 0.1)
    u = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    v = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    got = tpost.backflow(torch.from_numpy(disp), torch.from_numpy(v),
                         torch.from_numpy(u)).numpy()
    want = jpost.backflow(jnp.asarray(disp), jnp.asarray(v), jnp.asarray(u))
    assert_bitwise(got, want)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("win", [3, 5])
def test_census_transform(rng, C, win):
    """int32 words with the bits of mgm_tpu's uint32 words; NaN centres
    and neighbours (and the image border) give 0 bits."""
    img = _with_nans(rng, rng.integers(0, 6, (9, 11, C)).astype(np.float32),
                     0.1)
    got = tcensus.census_transform(torch.from_numpy(img), win // 2).numpy()
    want = np.asarray(jcensus.census_transform(jnp.asarray(img), win // 2))
    nwords = tcensus.census_words(C, win // 2)
    assert nwords == jcensus.census_words(C, win // 2)
    assert got.dtype == np.int32 and got.shape == (9, 11, nwords)
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("name", ["none", "sobelx", "gblur", "sobel_x"])
def test_apply_prefilter(rng, name):
    img = rng.uniform(0, 255, (9, 13, 3)).astype(np.float32)
    got = tpre.apply_prefilter(torch.from_numpy(img), name).numpy()
    assert_bitwise(got, jpre.apply_prefilter(jnp.asarray(img), name))


@pytest.mark.parametrize("sigma", [0.4, 1.0, 2.5])
def test_gblur(rng, sigma):
    for s in (sigma, -sigma, 7.0):   # 7.0: the width clamps at 39
        np.testing.assert_array_equal(tpre.gblur_kernel(s),
                                      jpre.gblur_kernel(s))
    img = rng.uniform(0, 255, (9, 13, 2)).astype(np.float32)
    assert_bitwise(tpre.gblur(torch.from_numpy(img), sigma).numpy(),
                   jpre.gblur(jnp.asarray(img), sigma))


def test_correlate2d_scan_order(rng):
    """A 3x5 kernel with a zero tap, clamp-to-edge, taps summed in
    (row, col) order."""
    k = rng.normal(size=(3, 5)).astype(np.float32)
    k[1, 2] = 0.0
    img = rng.normal(size=(7, 6, 2)).astype(np.float32)
    assert_bitwise(tpre.correlate2d(torch.from_numpy(img), k).numpy(),
                   jpre.correlate2d(jnp.asarray(img), k))
    assert_bitwise(tpre.sobelx(torch.from_numpy(img)).numpy(),
                   jpre.sobelx(jnp.asarray(img)))


@pytest.mark.parametrize("nan_frac", [0.0, 0.2, 1.0])
def test_update_dmin_dmax(rng, nan_frac):
    """TSGM_ITER's window update, bitwise: non-finite pixels take the
    global finite min/max; an all-NaN image keeps its windows."""
    d = _with_nans(rng, rng.uniform(-20, 12, (2, 9, 13)).astype(np.float32),
                   nan_frac)
    d[1, 0, 0] = np.inf
    lo = rng.uniform(-30, -20, d.shape).astype(np.float32)
    hi = rng.uniform(12, 20, d.shape).astype(np.float32)
    got = tpost.update_dmin_dmax(*(torch.from_numpy(a) for a in (d, lo, hi)))
    want = jpost.update_dmin_dmax(*(jnp.asarray(a) for a in (d, lo, hi)))
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("etype", [0, 1, 2])
def test_evaluate_energy_4connected(rng, etype):
    """The TSGM_DEBUG energies against mgm_tpu's: quarter-pixel
    disparities (some NaN, inf, out of window or out of the label
    axis), so every pairwise term is exact up to L2's square root; the
    per-pixel image is bitwise equal, as are the totals of types 0 and
    1 (exact sums), type 2's within 1e-6 relative (summation order)."""
    from mgm_tpu.ops.energy import evaluate_energy_4connected as jeval
    from mgm_tpu_torch.ops.energy import evaluate_energy_4connected as teval

    H, W, L, gmin = 9, 13, 12, -5
    d = (rng.integers(-20, 30, (H, W)) / 4.0).astype(np.float32)
    d = _with_nans(rng, d, 0.1)
    d[0, 1], d[3, 3] = np.inf, -np.inf
    d[4, 4], d[5, 6] = gmin - 3.0, gmin + L + 1.0   # outside the labels
    cc = rng.integers(0, 40, (H, W, L)).astype(np.float32)
    lo = rng.integers(0, 3, (H, W)).astype(np.int32)
    hi = rng.integers(8, L, (H, W)).astype(np.int32)
    cc = np.where((np.arange(L) >= lo[..., None])
                  & (np.arange(L) <= hi[..., None]), cc, np.inf)
    kw = dict(p1=8.0 * 3, p2=32.0 * 3, etype=etype)
    e_t, img_t = teval(*(torch.from_numpy(a) for a in (d, cc, lo, hi)),
                       gmin, **kw)
    e_j, img_j = jeval(*(jnp.asarray(a) for a in (d, cc, lo, hi)),
                       jnp.int32(gmin), **kw)
    assert_bitwise(img_t.numpy(), np.asarray(img_j))
    # with every data term finite the totals are finite too
    fin = np.isfinite(np.asarray(img_j))
    e_t2, _ = teval(torch.from_numpy(np.where(fin, d, 2.0).astype(
        np.float32)), *(torch.from_numpy(a) for a in (cc, lo, hi)), gmin, **kw)
    e_j2, _ = jeval(jnp.asarray(np.where(fin, d, 2.0).astype(np.float32)),
                    *(jnp.asarray(a) for a in (cc, lo, hi)), jnp.int32(gmin),
                    **kw)
    for a, b in ((e_t, e_j), (e_t2, e_j2)):
        if etype == 2:
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        else:
            assert_bitwise(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("C", [1, 3])
def test_write_tiff_without_imaging_packages(tmp_path, monkeypatch, C):
    """Without the native library, float TIFFs are written by the port's
    own writer, which needs no imaging package, and read back bit for
    bit by mgm_tpu's reader."""
    import sys

    from mgm_tpu.io import read_image
    from mgm_tpu_torch import io as tio

    rng = np.random.default_rng(C)
    img = rng.normal(0, 50, (5, 7, C)).astype(np.float32)
    img[0, 0, 0], img[1, 2, 0] = np.nan, np.inf
    path = str(tmp_path / "e.tif")
    with monkeypatch.context() as mp:
        mp.setattr(tio, "_native", lambda: None)
        mp.setitem(sys.modules, "imageio.v3", None)   # import fails
        tio.write_image(path, img)
    assert_bitwise(read_image(path), img)
