"""Bitwise equality of the port's prep and post ops with mgm_tpu's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgm_tpu.ops import post as jpost
from mgm_tpu.ops.weights import compute_weights as j_weights
from mgm_tpu_torch.ops import post as tpost
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
