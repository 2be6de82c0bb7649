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
