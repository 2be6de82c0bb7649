"""The port's batched pairs, tiled scene runner and checkpoints against
mgm_tpu's, and against the port's own single solves.

mgm_tpu runs its dense XLA path here (the CPU), the port the plain
PyTorch versions of its kernels; MGM_TPU_PACKOUT=0 keeps mgm_tpu's
outputs off its integer wire codec.  At TSGM 1 every output is
bitwise equal; a batch equals the port's own per-pair solves bitwise
at any TSGM (the same kernels on the same planes), and tiles solved in
batches equal tiles solved one by one.
"""
import os

import numpy as np
import pytest

from mgm_tpu.models import get_preset as jax_preset
from mgm_tpu.runner import main as jax_tiled_main
from mgm_tpu.runner import tiled_disparity as jax_tiled
from mgm_tpu.stereo import compute_disparity_batch as jax_batch
from mgm_tpu.utils import checkpoint as jckpt
from mgm_tpu_torch import compute_disparity, runner
from mgm_tpu_torch.config import from_jax
from mgm_tpu_torch.io import read_image, write_image
from mgm_tpu_torch.stereo import compute_disparity_batch
from mgm_tpu_torch.synthetic import synthetic_pair
from mgm_tpu_torch.utils import checkpoint as tckpt

from test_torch_kernels import assert_bitwise

BATCH_KEYS = ("disp", "cost", "disp_right", "cost_right")


@pytest.fixture
def no_packout(monkeypatch):
    monkeypatch.setenv("MGM_TPU_PACKOUT", "0")


def _pairs(K, H, W, dmin, dmax):
    ps = [synthetic_pair(H, W, dmin, dmax, seed=s)[:2] for s in range(K)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


@pytest.fixture
def scene():
    """A 20x30 scene whose disparities lie in -4..3."""
    u, v, _ = synthetic_pair(20, 30, -4, 3, seed=5)
    return u, v


def test_batch_matches_mgm_tpu(no_packout):
    """Three pairs at TSGM 1 (fast_ad, LR): bitwise."""
    us, vs = _pairs(3, 12, 20, -5, 3)
    cfg = jax_preset("fast_ad", dmin=-5, dmax=3, test_lr=True, mgm=1)
    want = jax_batch(us, vs, cfg, outputs=BATCH_KEYS)
    got = compute_disparity_batch(us, vs, from_jax(cfg), device="cpu",
                                  outputs=BATCH_KEYS)
    assert sorted(got) == sorted(want) == sorted(BATCH_KEYS)
    for k in BATCH_KEYS:
        assert got[k].shape == (3, 12, 20)
        assert_bitwise(got[k], want[k])


# the satellite preset (census 5x5, TSGM 3, vfit, median 1) with and
# without the LR check, census_tl (FH) with weights, and the NCC and
# TSGM_ITER configurations that take the sequential loop
@pytest.mark.parametrize("name,kw", [
    ("satellite", dict(test_lr=True)), ("satellite", {}),
    ("census_tl", dict(a_p2=0.5, a_thresh=20.0, test_lr=True)),
    ("ncc", dict(mgm=1)), ("fast_ad", dict(iterations=2, mgm=1))],
    ids=lambda x: str(x))
def test_batch_equals_its_pairs(name, kw):
    us, vs = _pairs(3, 12, 20, -5, 3)
    cfg = from_jax(jax_preset(name, dmin=-5, dmax=3, **kw))
    keys = BATCH_KEYS if cfg.test_lr else ("disp", "cost")
    got = compute_disparity_batch(us, vs, cfg, device="cpu", outputs=keys)
    assert sorted(got) == sorted(keys)
    for k in range(3):
        one = compute_disparity(us[k], vs[k], cfg, device="cpu")
        for key in keys:
            assert_bitwise(got[key][k], one[key])


def test_tiled_full_margin_equals_single_solve(scene):
    """A margin as large as the scene reproduces the single solve (the
    satellite preset, TSGM 3)."""
    u, v = scene
    cfg = from_jax(jax_preset("satellite", dmin=-4, dmax=3, test_lr=True))
    res = runner.tiled_disparity(u, v, cfg, tile=10, margin=30,
                                 device="cpu")
    one = compute_disparity(u, v, cfg, device="cpu")
    assert res["tiles_solved"] == 6
    assert_bitwise(res["disp"], one["disp"])
    assert_bitwise(res["cost"], one["cost"])


@pytest.mark.parametrize("pp", [False, True])
def test_tiled_matches_mgm_tpu(scene, no_packout, pp):
    """Tiles with a short margin, constant or per-pixel windows (cropped
    per tile), TSGM 1: bitwise."""
    u, v = scene
    cfg = jax_preset("fast_ad", dmin=-4, dmax=3, test_lr=True, mgm=1)
    kw = {}
    if pp:
        lo = np.full(u.shape[:2], -3.0, np.float32)
        lo[:, 15:] = -4.0
        kw = dict(dmin_img=lo, dmax_img=lo + 6.0)
    want = jax_tiled(u, v, cfg, tile=8, margin=3, **kw)
    got = runner.tiled_disparity(u, v, from_jax(cfg), tile=8, margin=3,
                                 device="cpu", **kw)
    assert got["tiles_solved"] == want["tiles_solved"] == 12
    for k in ("disp", "cost"):
        assert_bitwise(got[k], want[k])


def test_tiled_batches_equal_single_tiles(scene):
    u, v = scene
    cfg = from_jax(jax_preset("satellite", dmin=-4, dmax=3, test_lr=True))
    one = runner.tiled_disparity(u, v, cfg, tile=10, margin=3, batch=1,
                                 device="cpu")
    for batch in (2, None):       # None: each tile row in one batch
        many = runner.tiled_disparity(u, v, cfg, tile=10, margin=3,
                                      batch=batch, device="cpu")
        assert one["tiles_solved"] == many["tiles_solved"] == 6
        for k in ("disp", "cost"):
            assert_bitwise(many[k], one[k])


def test_checkpoint_resume(scene, tmp_path):
    """A run resumes from its checkpoints (removed tiles are solved
    again, the others loaded) and from a checkpoint directory that
    mgm_tpu.runner wrote."""
    u, v = scene
    jcfg = jax_preset("fast_ad", dmin=-4, dmax=3, test_lr=True, mgm=1)
    cfg = from_jax(jcfg)
    kw = dict(tile=8, margin=3, device="cpu")
    ck = tmp_path / "torch"
    first = runner.tiled_disparity(u, v, cfg, checkpoint_dir=str(ck), **kw)
    assert len(os.listdir(ck)) == 12
    os.remove(ck / "tile_8_16.npz")
    (ck / "tile_0_0.npz").write_bytes(b"not a checkpoint")
    again = runner.tiled_disparity(u, v, cfg, checkpoint_dir=str(ck), **kw)
    assert again["tiles_solved"] == 2
    for k in ("disp", "cost"):
        assert_bitwise(again[k], first[k])
    jk = tmp_path / "jax"
    jax_tiled(u, v, jcfg, tile=8, margin=3, checkpoint_dir=str(jk))
    resumed = runner.tiled_disparity(u, v, cfg, checkpoint_dir=str(jk), **kw)
    assert resumed["tiles_solved"] == 0
    for k in ("disp", "cost"):
        assert_bitwise(resumed[k], first[k])


def test_checkpoint_format(tmp_path):
    """save_state/load_state: the JAX package's .npz, either way; an
    absent or unreadable file loads as None."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    tckpt.save_state(str(tmp_path / "t.npz"), disp=a, cost=-a)
    jckpt.save_state(str(tmp_path / "j.npz"), disp=a, cost=-a)
    for load in (tckpt.load_state, jckpt.load_state):
        for f in ("t.npz", "j.npz"):
            st = load(str(tmp_path / f))
            assert sorted(st) == ["cost", "disp"]
            assert_bitwise(st["cost"], -a)
    assert not list(tmp_path.glob("*.tmp*"))
    (tmp_path / "bad.npz").write_bytes(b"\x00" * 10)
    assert tckpt.load_state(str(tmp_path / "bad.npz")) is None
    assert tckpt.load_state(str(tmp_path / "absent.npz")) is None


def test_tiled_cli_matches_mgm_tpu(scene, tmp_path, no_packout):
    u, v = scene
    for name, a in (("u", u), ("v", v)):
        write_image(str(tmp_path / f"{name}.tif"), a.astype(np.float32))
    args = [str(tmp_path / "u.tif"), str(tmp_path / "v.tif")]
    opts = ["--preset", "fast_ad", "-r", "-4", "-R", "3", "--tile", "8",
            "--margin", "3"]
    for name, main, kw in (("jax", jax_tiled_main, {}),
                           ("torch", runner.main, dict(device="cpu"))):
        out = [str(tmp_path / f"{name}_{k}.tif") for k in ("disp", "cost")]
        assert main(args + out + opts, **kw) == 0
    for k in ("disp", "cost"):
        assert_bitwise(read_image(str(tmp_path / f"torch_{k}.tif")),
                       read_image(str(tmp_path / f"jax_{k}.tif")))


def test_tiled_cli_refuses_missing_gpu(scene, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_image(str(tmp_path / "u.tif"), scene[0].astype(np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.main([str(tmp_path / "u.tif")] * 2 + [str(tmp_path / "d.tif")])
