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
