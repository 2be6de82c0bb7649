"""The plain reference against the port's CPU run (its plain kernels) on
small crops of both configurations: the same maps up to rounding.
The port runs its fused branch for cfg1 and its dense branch for ncc;
the reference follows neither."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, traffic
from benchmark.reference import mgm as ref
from benchmark.spec import read_json
from benchmark.tests._tiny import REPO


def _pool(config, seed, n=2):
    return traffic.make_pool(config, dict(pool_pairs=n), seed, "cpu")


@pytest.mark.parametrize("name,H,W,dmin,dmax", [
    ("cfg1", 24, 40, -12, 4), ("ncc", 24, 40, -12, 4),
    ("cfg1", 17, 29, -3, 9), ("ncc", 19, 30, -9, 2)])
def test_reference_matches_the_port_on_the_cpu(name, H, W, dmin, dmax):
    from mgm_tpu_torch import stereo
    from mgm_tpu_torch.config import MGMConfig

    config = read_json(REPO / "benchmark" / "configs" / f"{name}.json")
    config.update(height=H, width=W)
    config["settings"].update(dmin=dmin, dmax=dmax)
    us, vs = _pool(config, 17)
    r = ref.disparity(us, vs, config["settings"], device="cpu")
    cfg = MGMConfig(**config["settings"])
    for k in range(len(us)):
        p = stereo.compute_disparity(us[k], vs[k], cfg, device="cpu",
                                     outputs=("disp", "cost"))
        n = check.compare_pair(p["disp"], p["cost"], r["disp"][k],
                               r["cost"][k])
        assert n["mismatch"] == 0.0
        # the port sums the passes in its own order: a few float32 ulps
        # of S, amplified by vfit's division
        assert n["cost_gap"] < 2e-4
        assert np.isfinite(r["disp"][k]).mean() > 0.5


def test_schedules_put_every_neighbour_earlier():
    for p, dirs in enumerate(ref.PASS_DIRS):
        for mgm in (1, 2, 3, 4):
            T, a, b = ref._schedule(dirs[:mgm], 50, 70)
            assert all(a * dx + b * dy < 0 for dx, dy in dirs[:mgm])
            assert T <= 50 + 70 - 1 or mgm > 2


def test_bfloat16_changes_the_answer():
    config = read_json(REPO / "benchmark" / "configs" / "cfg1.json")
    config.update(height=24, width=40)
    config["settings"].update(dmin=-12, dmax=4)
    us, vs = _pool(config, 3, 1)
    a = ref.disparity(us, vs, config["settings"], device="cpu")
    b = ref.disparity(us, vs, config["settings"], device="cpu",
                      dtype=torch.bfloat16)
    n = check.compare_pair(b["disp"][0], b["cost"][0], a["disp"][0],
                           a["cost"][0])
    assert n["mismatch"] > 0.01 or n["cost_gap"] > 1e-3


def test_unsupported_settings_are_refused():
    with pytest.raises(ValueError):
        ref.settings_of(dict(distance="census"))
    with pytest.raises(ValueError):
        ref.settings_of(dict(median_radius=1))
