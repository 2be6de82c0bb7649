"""The port's pipeline and CLI against mgm_tpu's, at cfg1's settings.

mgm_tpu runs its dense XLA path here (the CPU), the port the plain
PyTorch versions of its kernels.  MGM_TPU_PACKOUT=0 keeps mgm_tpu's
outputs off its integer wire codec.  At TSGM = 1 every output is
bitwise equal.  At TSGM >= 2 the fused and dense sum orders differ
(docs/ARCHITECTURE.md "Numerical-parity policy"): at most 0.5 % of the
disparities of each output may differ (argmin ties, and the LR-check
verdicts they flip), and where both sides agree on a disparity the
costs agree to 3e-5 relative (float32 sums of a few hundred terms); with
the truncated-linear potential at P2 20000 (costs near 1e5, where a
cost near 0 sums terms of that size) also to 3e-5 of the largest finite
cost.
"""
import numpy as np
import pytest
import torch

import mgm_tpu.cli as jcli
from mgm_tpu.config import MGMConfig as JaxConfig
from mgm_tpu.io import read_image, write_image
from mgm_tpu.models import get_preset as jax_preset
from mgm_tpu.stereo import compute_disparity as jax_disparity
from mgm_tpu_torch import cli as tcli
from mgm_tpu_torch import compute_disparity
from mgm_tpu_torch.config import from_jax
from mgm_tpu_torch.synthetic import synthetic_pair

from test_torch_kernels import assert_bitwise

# bench.py's cfg1: AD, -r -120 -R 30 (L = 151), -O 4, TSGM 2, P1 8, P2 32,
# LR both ways
CFG1 = JaxConfig(dmin=-120, dmax=30, ndir=4, mgm=2, distance="ad", p1=8,
                 p2=32, test_lr=True)
KEYS = ("disp", "cost", "disp_nolr", "backflow", "disp_right", "cost_right",
        "disp_nolr_right")


@pytest.fixture
def pair():
    u, v, _ = synthetic_pair(24, 40, -8, 4, seed=3)
    return u, v


@pytest.fixture
def no_packout(monkeypatch):
    monkeypatch.setenv("MGM_TPU_PACKOUT", "0")


def test_cfg1_tsgm1_bitwise(pair, no_packout):
    cfg = CFG1.replace(mgm=1)
    want = jax_disparity(*pair, cfg)
    got = compute_disparity(*pair, from_jax(cfg), device="cpu")
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        assert_bitwise(got[k], want[k])


def _assert_near(got, want, scaled=False):
    """The TSGM >= 2 tolerance of the module docstring (`scaled`: costs
    also within 3e-5 of the largest finite cost)."""
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in ("disp", "disp_nolr", "disp_right", "disp_nolr_right"):
        same = (got[k] == want[k]) | (np.isnan(got[k]) & np.isnan(want[k]))
        assert 1.0 - same.mean() <= 0.005, k
        if k == "disp":  # the warp follows the final left disparity
            assert_bitwise(got["backflow"][same], want["backflow"][same])
    for side in ("", "_right"):
        agree = got["disp_nolr" + side] == want["disp_nolr" + side]
        wc = want["cost" + side]
        atol = 3e-5 * max(1.0, np.abs(wc[np.isfinite(wc)]).max()) \
            if scaled else 0.0
        np.testing.assert_allclose(got["cost" + side][agree], wc[agree],
                                   rtol=3e-5, atol=atol)
    # the pair is solvable: most pixels pass the LR check
    assert np.isfinite(got["disp"]).mean() > 0.5


def test_cfg1_tsgm2(pair, no_packout):
    want = jax_disparity(*pair, CFG1)
    got = compute_disparity(*pair, from_jax(CFG1), device="cpu")
    _assert_near(got, want)


# the fast_ad rows of scripts/bench_matrix.py beyond cfg1: full_16dir
# (ndir 16: A/B + V groups and the knight passes through the dense
# path), cfg1_tsgm4 (A + PB) and ndir 8 at TSGM 4 (A/B + PA/PB), and
# ndir 16 at TSGM 1, where every output is bitwise equal; over the
# pair's own disparity range, which keeps each case to seconds
@pytest.mark.parametrize("kw", [dict(ndir=16, mgm=1), dict(ndir=16),
                                dict(mgm=4), dict(ndir=8, mgm=4)],
                         ids=lambda c: str(sorted(c.items())))
def test_fast_ad_schedules(pair, no_packout, kw):
    cfg = jax_preset("fast_ad", dmin=-8, dmax=4, test_lr=True, **kw)
    want = jax_disparity(*pair, cfg)
    got = compute_disparity(*pair, from_jax(cfg), device="cpu")
    if cfg.mgm > 1:
        _assert_near(got, want)
        return
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        assert_bitwise(got[k], want[k])


def test_outputs_filter(pair):
    got = compute_disparity(*pair, from_jax(CFG1.replace(mgm=1)),
                            device="cpu", outputs=("disp", "cost"))
    assert sorted(got) == ["cost", "disp"]
    assert all(a.dtype == np.float32 and a.shape == (24, 40)
               for a in got.values())


def _windows(d, seed=0, widen=False):
    """-m/-M images around the true disparity d: truth -2 +- 2 .. truth
    + 3, with a NaN minimum (-> dmin), a maximum below its minimum
    (-> ceil(lo + 1)) and, with `widen`, one pixel each below dmin and
    above dmax (the global label axis grows)."""
    rng = np.random.default_rng(seed)
    lo = (d - 2 + rng.integers(-2, 2, d.shape)).astype(np.float32)
    hi = (d + 3).astype(np.float32)
    lo[0, 0] = np.nan
    hi[2, 3] = lo[2, 3] - 1.5
    if widen:
        lo[5, 5], hi[6, 6] = d.min() - 6, d.max() + 6
    return lo, hi


@pytest.fixture
def pair_d():
    return synthetic_pair(24, 40, -8, 4, seed=3)


def _assert_item6(got, want, cfg):
    """Bitwise at TSGM 1 (NCC: test_ncc_preset_matches_mgm_tpu's
    tolerance), the near-tie rule at TSGM >= 2; with the truncated-linear
    potential (FH at P2 20000: costs near 1e5) costs within 3e-5 of the
    largest finite cost."""
    if cfg.distance == "ncc":
        assert sorted(got) == sorted(want) == sorted(KEYS)
        for k in ("disp", "disp_nolr", "disp_right", "disp_nolr_right"):
            assert_bitwise(got[k], want[k])   # integer labels: no vfit
        for k in ("cost", "cost_right"):
            np.testing.assert_allclose(got[k], want[k], atol=5e-3, rtol=1e-5)
    elif cfg.mgm == 1:
        assert sorted(got) == sorted(want) == sorted(KEYS)
        for k in KEYS:
            assert_bitwise(got[k], want[k])
    else:
        _assert_near(got, want, scaled=cfg.use_trunc_linear)


# The configurations the port refused before per-pixel windows,
# TSGM_ITER and TSGM_DEBUG were ported: cfg1 (TSGM 2, -120..30) with
# each of them, on both branches.  With TSGM_DEBUG the port prints one
# energy line per iteration as mgm_tpu does (values within 1e-6
# relative: the totals sum in another order, and NCC's volume differs
# in the last bits) and writes the energy image (the L1 map), equal to
# mgm_tpu's dump within 1e-6 relative (NCC: the cost tolerance of
# test_ncc_preset_matches_mgm_tpu, 5e-3 absolute + 1e-5 relative).
@pytest.mark.parametrize("kw", [
    dict(iterations=2), dict(debug=True, iterations=2),
    dict(distance="ncc", iterations=2, mgm=1),
    dict(distance="ncc", debug=True, mgm=1),
], ids=lambda c: str(sorted(c.items())))
def test_item6_configs_match_mgm_tpu(pair, no_packout, monkeypatch, tmp_path,
                                     capsys, kw):
    cfg = CFG1.replace(**kw)
    _energy_dumps_to(monkeypatch, tmp_path)
    want = jax_disparity(*pair, cfg)
    printed_jax = capsys.readouterr().out
    got = compute_disparity(*pair, from_jax(cfg), device="cpu")
    printed = capsys.readouterr().out
    _assert_item6(got, want, cfg)
    if not cfg.debug:
        assert "ENERGY" not in printed
        return

    def energies(text):
        lines = [ln for ln in text.splitlines() if "ENERGY" in ln]
        return np.array([[float(x.split()[-1]) for x in ln.split("\t")]
                         for ln in lines])

    assert energies(printed).shape == energies(printed_jax).shape == (
        cfg.iterations, 3)
    np.testing.assert_allclose(energies(printed), energies(printed_jax),
                               rtol=1e-6)
    assert printed.splitlines()[0].startswith(" ENERGY L1trunc: ")
    tol = (dict(atol=5e-3, rtol=1e-5) if cfg.distance == "ncc"
           else dict(rtol=1e-6))
    np.testing.assert_allclose(
        read_image(str(tmp_path / "ENERGY_L1trunc.tif")),
        read_image(str(tmp_path / "jax_ENERGY_L1trunc.tif")), **tol)


def test_per_pixel_windows_match_mgm_tpu(pair_d, no_packout):
    u, v, d = pair_d
    lo, hi = _windows(d)
    want = jax_disparity(u, v, CFG1, dmin_img=lo, dmax_img=hi)
    got = compute_disparity(u, v, from_jax(CFG1), device="cpu",
                            dmin_img=lo, dmax_img=hi)
    _assert_near(got, want)


# per-pixel windows on the fused branch (fast_ad at TSGM 1 and 2;
# census_tl, where FH restricts each message to the target's window;
# ndir 16, the knight passes dense with their own windows) and on the
# dense branch (ncc), and windows that widen the label axis beyond
# dmin..dmax
PP_CASES = {
    "fast_ad_tsgm1_wider_axis": ("fast_ad", dict(mgm=1), True),
    "fast_ad_tsgm2": ("fast_ad", {}, False),
    "census_tl_fh_restrict": ("census_tl", dict(refinement="none",
                                                median_radius=0), False),
    "fast_ad_ndir16": ("fast_ad", dict(ndir=16, mgm=1), False),
    "ncc_wider_axis": ("ncc", dict(mgm=1, refinement="none"), True),
}


@pytest.mark.parametrize("case", list(PP_CASES))
def test_per_pixel_windows(pair_d, no_packout, case):
    name, kw, widen = PP_CASES[case]
    u, v, d = pair_d
    lo, hi = _windows(d, widen=widen)
    cfg = jax_preset(name, dmin=-8, dmax=4, test_lr=True, **kw)
    want = jax_disparity(u, v, cfg, dmin_img=lo, dmax_img=hi)
    got = compute_disparity(u, v, from_jax(cfg), device="cpu",
                            dmin_img=lo, dmax_img=hi)
    _assert_item6(got, want, cfg)


# TSGM_ITER 3 on both branches (2: test_item6_configs_match_mgm_tpu),
# and with per-pixel windows
@pytest.mark.parametrize("name,iters,pp", [
    ("fast_ad", 3, False), ("ncc", 3, False), ("fast_ad", 2, True)])
def test_tsgm_iter(pair_d, no_packout, name, iters, pp):
    u, v, d = pair_d
    kw = dict(dmin_img=_windows(d)[0], dmax_img=_windows(d)[1]) if pp else {}
    cfg = jax_preset(name, dmin=-8, dmax=4, test_lr=True, mgm=1,
                     iterations=iters, refinement="none")
    want = jax_disparity(u, v, cfg, **kw)
    got = compute_disparity(u, v, from_jax(cfg), device="cpu", **kw)
    _assert_item6(got, want, cfg)


def _energy_dumps_to(monkeypatch, tmp_path):
    """Both packages write their TSGM_DEBUG image to the reference's
    fixed path, /tmp/ENERGY_L1trunc.tif (the port's is
    stereo.ENERGY_DUMP): both go to tmp_path here (mgm_tpu's under
    jax_ENERGY_L1trunc.tif)."""
    from mgm_tpu_torch import stereo as tstereo

    from mgm_tpu.ops import energy as jenergy

    real = jenergy.print_solution_energy

    def redirected(*a, dump_path=None, **k):
        return real(*a, dump_path=str(tmp_path / "jax_ENERGY_L1trunc.tif"),
                    **k)

    monkeypatch.setattr(jenergy, "print_solution_energy", redirected)
    monkeypatch.setattr(tstereo, "ENERGY_DUMP",
                        str(tmp_path / "ENERGY_L1trunc.tif"))


def test_cli_matches_mgm_tpu_cli(tmp_path, monkeypatch, pair, no_packout):
    u, v = pair
    write_image(str(tmp_path / "u.tif"), u.astype(np.float32))
    write_image(str(tmp_path / "v.tif"), v.astype(np.float32))
    for k, val in dict(TSGM=1, TESTLRRL=1, MEDIAN=1).items():
        monkeypatch.setenv(k, str(val))
    args = ["-r", "-120", "-R", "30", "-O", "4", "-P1", "8", "-P2", "32",
            str(tmp_path / "u.tif"), str(tmp_path / "v.tif")]
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("torch", tcli.main, dict(device="cpu"))):
        files = [str(tmp_path / f"{name}_{k}.tif")
                 for k in ("disp", "cost", "back")]
        nolr = str(tmp_path / f"{name}_nolr.tif")
        assert main(["-l", nolr] + args + files, **kw) == 0
        outs[name] = [read_image(f) for f in files + [nolr]]
    for got, want in zip(outs["torch"], outs["jax"]):
        assert_bitwise(got, want)


def test_cli_windows_match_mgm_tpu_cli(tmp_path, monkeypatch, pair_d,
                                       no_packout):
    """-m/-M image files through both CLIs: equal output files."""
    u, v, d = pair_d
    lo, hi = _windows(d)
    for name, a in (("u", u), ("v", v), ("m", lo), ("M", hi)):
        write_image(str(tmp_path / f"{name}.tif"), a.astype(np.float32))
    for k, val in dict(TSGM=1, TESTLRRL=1).items():
        monkeypatch.setenv(k, str(val))
    args = ["-r", "-8", "-R", "4", "-m", str(tmp_path / "m.tif"), "-M",
            str(tmp_path / "M.tif"), str(tmp_path / "u.tif"),
            str(tmp_path / "v.tif")]
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("torch", tcli.main, dict(device="cpu"))):
        files = [str(tmp_path / f"{name}_{k}.tif") for k in ("disp", "cost")]
        assert main(args + files, **kw) == 0
        outs[name] = [read_image(f) for f in files]
    for got, want in zip(outs["torch"], outs["jax"]):
        assert_bitwise(got, want)


def test_cli_refuses_missing_gpu(tmp_path, pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_image(str(tmp_path / "u.tif"), pair[0].astype(np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([str(tmp_path / "u.tif")] * 2 + [str(tmp_path / "d.tif")])


def test_cli_help(capsys):
    assert tcli.main(["--help"]) == 0
    assert "disparity" in capsys.readouterr().out.lower()


@pytest.fixture(scope="module", params=["preset", "weighted_fh"])
def ncc_runs(request):
    """The `ncc` preset (8 directions, TSGM 2, NCC window 5, vfit, LR),
    and the same with adaptive weights and the truncated-linear
    potential at TSGM 3, on a 16x24 crop through both packages:
    (mgm_tpu's, the port's)."""
    u, v, _ = synthetic_pair(16, 24, -6, 3, seed=3)
    cfg = jax_preset("ncc", dmin=-6, dmax=3)
    if request.param == "weighted_fh":
        cfg = cfg.replace(a_p2=0.5, a_thresh=20.0, use_trunc_linear=True,
                          mgm=3, p1=2, p2=20)
    return (jax_disparity(u, v, cfg),
            compute_disparity(u, v, from_jax(cfg), device="cpu"))


def test_ncc_preset_matches_mgm_tpu(ncc_runs):
    """mgm_tpu jits its NCC volume, and XLA's fusions round it
    differently from the op-by-op arithmetic the port shares with
    mgm_tpu's eager _ncc_costs (entries differ by up to ~1e-4,
    tests/test_torch_aggregate.py).  So: equal NaN masks, the same
    integer label everywhere but at most 1 % of pixels (near-ties),
    subpixel disparities within 1e-4 px and costs within 5e-3 absolute
    + 1e-5 relative where the labels agree."""
    want, got = ncc_runs
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for side in ("", "_right"):
        for k in ("disp" + side, "disp_nolr" + side):
            g, w = got[k], want[k]
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            fin = np.isfinite(w)
            same = np.round(g[fin]) == np.round(w[fin])
            assert 1.0 - same.mean() <= 0.01, k
            np.testing.assert_allclose(g[fin][same], w[fin][same], atol=1e-4,
                                       rtol=0)
        agree = np.round(got["disp_nolr" + side]) == np.round(
            want["disp_nolr" + side])
        np.testing.assert_allclose(got["cost" + side][agree],
                                   want["cost" + side][agree], atol=5e-3,
                                   rtol=1e-5)
    same = got["disp"] == want["disp"]
    assert_bitwise(got["backflow"][same], want["backflow"][same])
    # subpixel output, and the pair is solvable
    assert np.isfinite(got["disp"]).mean() > 0.5
    assert (got["disp"][np.isfinite(got["disp"])] % 1 != 0).any()


def test_compute_disparity_defaults_to_the_gpu(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        compute_disparity(*pair, from_jax(CFG1))


# the presets of models/presets.py beyond fast_ad and ncc, and what
# they combine: the census distance (census_tl, satellite with a 5x5
# window and three words a pixel, full_16dir), the truncated-linear
# potential (census_tl, sobelx_tl at trunc_dist 63, full_16dir), BT
# (bt, with parabola refinement), vfit, the median, the knight passes
# (full_16dir at TSGM 4: A/B + PA/PB and eight leftover passes), the
# sobelx and gblur prefilters (NCC's dense branch, BT's fused one),
# and adaptive weights with census at a finite trunc_dist (1 word a
# pixel: trunc_dist * 1, not * 3 channels) at TSGM 1, where every
# disparity output is bitwise equal
PRESET_RUNS = {
    "census_tl": ("census_tl", {}), "sobelx_tl": ("sobelx_tl", {}),
    "satellite": ("satellite", {}), "bt": ("bt", {}),
    "full_16dir": ("full_16dir", {}),
    "ncc_sobelx": ("ncc", dict(prefilter="sobelx")),
    "bt_gblur": ("bt", dict(prefilter="gblur")),
    "census_weighted_tsgm1": ("census_tl", dict(mgm=1, a_p2=0.5,
                                                a_thresh=20.0,
                                                trunc_dist=4.0)),
}


@pytest.fixture(scope="module", params=list(PRESET_RUNS))
def preset_run(request):
    """(name, mgm_tpu's outputs, the port's) on a 16x24 crop over
    -6..3, LR both ways, mgm_tpu run once a preset."""
    name, kw = PRESET_RUNS[request.param]
    u, v, _ = synthetic_pair(16, 24, -6, 3, seed=3)
    cfg = jax_preset(name, dmin=-6, dmax=3, test_lr=True, **kw)
    mp = pytest.MonkeyPatch()
    mp.setenv("MGM_TPU_PACKOUT", "0")
    try:
        want = jax_disparity(u, v, cfg)
    finally:
        mp.undo()
    return (request.param, cfg, want,
            compute_disparity(u, v, from_jax(cfg), device="cpu"))


def test_presets_match_mgm_tpu(preset_run):
    """The fused and dense sums run in different orders, and mgm_tpu
    jits its refinement and prep, where XLA contracts a*b + c into one
    fused multiply-add (the fits' v2 + (x - 1)*slope, the blur's taps)
    while the port rounds each operation.  So: equal NaN masks
    everywhere (the LR check's verdicts agree); integer labels
    (rounded disparities) equal but at most 1 % of pixels (argmin
    near-ties; none on these crops); refined disparities within 1e-4
    px where the labels agree (at most 1.4e-5 px measured); costs
    within 3e-5 of the largest cost and 3e-5 relative there (a refined
    cost is a fit's minimum, which may lie near 0; NCC: 5e-3 absolute
    + 1e-5 relative, as test_ncc_preset_matches_mgm_tpu).  At TSGM 1
    the disparities and backflow are bitwise equal and the costs
    within 1e-6 of the largest cost (the FMA)."""
    name, cfg, want, got = preset_run
    assert sorted(got) == sorted(want) == sorted(KEYS)
    tsgm1 = cfg.mgm == 1
    for side in ("", "_right"):
        for k in ("disp" + side, "disp_nolr" + side):
            g, w = got[k], want[k]
            if tsgm1:
                assert_bitwise(g, w)
                continue
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            fin = np.isfinite(w)
            same = np.round(g[fin]) == np.round(w[fin])
            assert 1.0 - same.mean() <= 0.01, k
            np.testing.assert_allclose(g[fin][same], w[fin][same], atol=1e-4,
                                       rtol=0)
        agree = np.round(got["disp_nolr" + side]) == np.round(
            want["disp_nolr" + side])
        wc = want["cost" + side]
        scale = max(1.0, np.abs(wc[np.isfinite(wc)]).max())
        eps = 1e-6 if tsgm1 else 3e-5
        tol = (dict(atol=5e-3, rtol=1e-5) if cfg.distance == "ncc"
               else dict(atol=eps * scale, rtol=eps))
        np.testing.assert_allclose(got["cost" + side][agree], wc[agree],
                                   **tol)
    same = got["disp"] == want["disp"]
    assert_bitwise(got["backflow"][same], want["backflow"][same])
    # the pair is solvable and, where the preset refines, subpixel
    fin = np.isfinite(got["disp"])
    assert fin.mean() > 0.5, name
    assert (got["disp"][fin] % 1 != 0).any(), name
