"""The port's pipeline and CLI against mgm_tpu's, at cfg1's settings.

mgm_tpu runs its dense XLA path here (the CPU), the port the plain
PyTorch versions of its kernels.  MGM_TPU_PACKOUT=0 keeps mgm_tpu's
outputs off its integer wire codec.  At TSGM = 1 every output is
bitwise equal.  At TSGM = 2 the fused and dense sum orders differ
(docs/ARCHITECTURE.md "Numerical-parity policy"): at most 0.5 % of the
disparities of each output may differ (argmin ties, and the LR-check
verdicts they flip), and where both sides agree on a disparity the
costs agree to 3e-5 relative (float32 sums of a few hundred terms).
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


def test_cfg1_tsgm2(pair, no_packout):
    want = jax_disparity(*pair, CFG1)
    got = compute_disparity(*pair, from_jax(CFG1), device="cpu")
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in ("disp", "disp_nolr", "disp_right", "disp_nolr_right"):
        same = (got[k] == want[k]) | (np.isnan(got[k]) & np.isnan(want[k]))
        assert 1.0 - same.mean() <= 0.005, k
        if k == "disp":  # the warp follows the final left disparity
            assert_bitwise(got["backflow"][same], want["backflow"][same])
    for side in ("", "_right"):
        agree = got["disp_nolr" + side] == want["disp_nolr" + side]
        np.testing.assert_allclose(got["cost" + side][agree],
                                   want["cost" + side][agree], rtol=3e-5)
    # the pair is solvable: most pixels pass the LR check
    assert np.isfinite(got["disp"]).mean() > 0.5


def test_outputs_filter(pair):
    got = compute_disparity(*pair, from_jax(CFG1.replace(mgm=1)),
                            device="cpu", outputs=("disp", "cost"))
    assert sorted(got) == ["cost", "disp"]
    assert all(a.dtype == np.float32 and a.shape == (24, 40)
               for a in got.values())


@pytest.mark.parametrize("kw,match", [
    (dict(mgm=4), "ROADMAP"), (dict(iterations=2), "ROADMAP"),
    (dict(refinement="vfit"), "ROADMAP"), (dict(distance="census"),
                                           "ROADMAP"),
    (dict(prefilter="gblur"), "ROADMAP"), (dict(a_p2=0.5), "ROADMAP"),
    (dict(distance="ncc", iterations=2), "item 6"),
    (dict(distance="ncc", debug=True), "item 6"),
    (dict(distance="ncc", prefilter="sobelx"), "item 2"),
])
def test_unsupported_raise(pair, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        compute_disparity(*pair, from_jax(CFG1.replace(**kw)), device="cpu")


def test_per_pixel_windows_raise(pair):
    m = np.zeros(pair[0].shape[:2], np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compute_disparity(*pair, from_jax(CFG1), device="cpu",
                          dmin_img=m - 5, dmax_img=m + 5)


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
