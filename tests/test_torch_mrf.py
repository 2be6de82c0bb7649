"""The port's dense solve, refinement and mgm_o solver against mgm_tpu's.

mgm_tpu runs its XLA path here (the CPU); the port runs the plain
PyTorch versions of K6/K5/K7.  Tolerances: S with equal inf/NaN masks
and signs, finite values within atol 2e-3, rtol 1e-6 (the K5-against-
XLA tolerance of tests/test_pallas.py); disparities equal except where
the two S minima lie within that tolerance of each other (near-ties);
mgm_o labels and files equal byte for byte (the stated problems have
no near-ties).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgm_tpu import mrf as jmrf
from mgm_tpu import mrf_cli as jcli
from mgm_tpu import solver as jsolver
from mgm_tpu.ops import refine as jrefine
from mgm_tpu_torch import mrf as tmrf
from mgm_tpu_torch import mrf_cli as tcli
from mgm_tpu_torch import solver as tsolver
from mgm_tpu_torch.ops import refine as trefine
from mgm_tpu_torch.synthetic import synthetic_mrf

from test_torch_aggregate import make_problem
from test_torch_kernels import assert_bitwise


def _close(a, b):
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert np.array_equal(fa, fb)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    nn = ~fa & ~np.isnan(a)
    assert np.array_equal(np.sign(a[nn]), np.sign(b[nn]))
    np.testing.assert_allclose(a[fa], b[fa], atol=2e-3, rtol=1e-6)


@pytest.fixture(scope="module")
def solved():
    """One mgm_solve of each package on a problem with per-pixel CC
    windows, tighter S windows (NaN/-inf cells after the overcount fix)
    and weights: (jax outputs, port outputs, problem)."""
    rng = np.random.default_rng(5)
    cc, w8, lo, hi = make_problem(rng, per_pixel=True, weighted=True)
    s_lo = np.minimum(lo + 1, hi).astype(np.int32)
    s_hi = hi.copy()
    gmin = np.array([-3, 2], np.int32)
    kw = dict(p1=8.0, p2=32.0, ndir=8, mgm=2, use_fh=False,
              use_weights=True, per_pixel=True, fix_overcount=True)
    args = (cc, w8, lo, hi, s_lo, s_hi, gmin)
    want = [np.asarray(x) for x in jsolver.mgm_solve(
        *map(jnp.asarray, args), backend="xla", **kw)]
    got = [x.numpy() for x in tsolver.mgm_solve(
        *map(torch.from_numpy, args), **kw)]
    return want, got, args


def test_mgm_solve_matches_jax(solved):
    (S0, d0, c0), (S1, d1, c1), _ = solved
    _close(S0, S1)
    # near-ties: the two smallest finite S values within the tolerance
    cand = np.where(np.isfinite(S0), S0, np.inf)
    two = np.sort(cand, -1)[..., :2]
    tie = np.abs(two[..., 1] - two[..., 0]) <= 2e-3 + 1e-6 * np.abs(two[..., 0])
    np.testing.assert_array_equal(d1[~tie], d0[~tie])
    _close(c0, c1)


@pytest.mark.parametrize("method", ["vfit", "parabola", "parabolaOCV",
                                    "cubic"])
def test_refine_matches_jax(solved, method):
    """Refinement on the same S (mgm_tpu's): the fit bitwise equal to
    mgm_tpu's run op by op (eagerly); the jitted subpixel_refine within
    rtol 1e-6 (XLA's fusions round differently), with equal NaN masks;
    the taps variant equal to the volume variant."""
    (S, disp, cost), _, args = solved
    s_lo, s_hi, gmin = args[4:]
    t = [torch.from_numpy(np.array(x))
         for x in (S, disp, cost, s_lo, s_hi, gmin)]
    taps = trefine.taps_from_S(t[0], t[1], t[5])
    jtaps = np.asarray(jrefine.taps_from_S(
        jnp.asarray(S), jnp.asarray(disp), jnp.asarray(gmin)))
    np.testing.assert_array_equal(taps.numpy(), jtaps)
    fit = trefine._FITS[method](*(taps[:, :, k] for k in range(4)))
    jfit = jrefine._FITS[method](*(jnp.asarray(jtaps[:, :, k])
                                   for k in range(4)))
    for g, w in zip(fit, jfit):
        assert_bitwise(g.numpy(), np.asarray(w))
    want = [np.asarray(x) for x in jrefine.subpixel_refine(
        *map(jnp.asarray, (S, disp, cost, s_lo, s_hi, gmin)), method=method)]
    got = trefine.subpixel_refine(*t, method=method)
    got2 = trefine.subpixel_refine_taps(taps, *t[1:], method=method)
    for g, g2, w in zip(got, got2, want):
        np.testing.assert_array_equal(g2.numpy(), g.numpy())
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def mrf_problem():
    return synthetic_mrf(12, 15, 10, seed=7)


@pytest.mark.parametrize("vtype", [0, 1])
def test_solve_mrf_matches_jax(mrf_problem, vtype):
    unary, w8, _ = mrf_problem
    want = jmrf.solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w8)
    got = tmrf.solve_mrf(unary, 8, 8.0, 32.0, 2, vtype, w8, device="cpu")
    assert got.dtype == np.float32 and got.shape == (12, 15)
    np.testing.assert_array_equal(got, want)


def test_write_problem_reads_back_in_both_packages(tmp_path, mrf_problem):
    """write_problem is read_problem's inverse, and mgm_tpu's reader
    sees the same arrays in the file."""
    unary, w8, _ = mrf_problem
    f_in = str(tmp_path / "input.bin")
    tcli.write_problem(f_in, unary, w8, ndir=16)
    assert (tmp_path / "input.bin").stat().st_size == 16 + 12 * 15 * 18 * 4
    for read in (tcli.read_problem, jcli.read_problem):
        un, w, ndir = read(f_in)
        np.testing.assert_array_equal(un, unary)
        np.testing.assert_array_equal(w, w8)
        assert ndir == 16


def test_mrf_cli_matches_mgm_tpu_bytes(tmp_path, mrf_problem):
    unary, w8, _ = mrf_problem
    f_in = str(tmp_path / "input.bin")
    tcli.write_problem(f_in, unary, w8)
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("torch", tcli.main, dict(device="cpu"))):
        f_out = tmp_path / f"{name}.bin"
        assert main([f_in, str(f_out), "8", "32", "2", "1"], **kw) == 0
        outs[name] = f_out.read_bytes()
    assert len(outs["torch"]) == 12 * 15 * 4
    assert outs["torch"] == outs["jax"]


def test_mrf_cli_usage_and_missing_gpu(tmp_path, capsys, mrf_problem):
    assert tcli.USAGE == jcli.USAGE
    assert tcli.main([], device="cpu") == 1
    assert capsys.readouterr().err == "too few parameters\n" + jcli.USAGE
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    f_in = str(tmp_path / "input.bin")
    tcli.write_problem(f_in, *mrf_problem[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([f_in, str(tmp_path / "out.bin")])
