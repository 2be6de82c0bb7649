"""Named pipeline presets (mirror of mgm_tpu/models/presets.py).

Each preset is a complete MGMConfig for a published/benchmark
configuration; `compute_disparity(u, v, get_preset("census_tl"))` is a
one-liner reproduction.  The first four mirror BASELINE.md / the
reference's own example configs (Makefile:16-18, README.txt:90,107 of
gfacciol/mgm).
"""
from __future__ import annotations

from ..config import MGMConfig

PRESETS: dict[str, MGMConfig] = {
    # BASELINE cfg1: stock defaults, AD cost, 4 dirs, TSGM=2
    "fast_ad": MGMConfig(ndir=4, mgm=2, distance="ad"),
    # BASELINE cfg2 / reference `make test` census config
    # (Makefile:17): best-quality census + truncated-linear
    "census_tl": MGMConfig(ndir=8, mgm=3, distance="census", p1=2, p2=20000,
                           use_trunc_linear=True, refinement="vfit",
                           median_radius=1),
    # BASELINE cfg4 / README.txt:90 flagship example ("sobel_x" is not a
    # registered prefilter name and silently resolves to none -
    # mgm_costvolume.h:197,201-207; reproduced faithfully)
    "sobelx_tl": MGMConfig(ndir=8, mgm=3, prefilter="sobel_x",
                           use_trunc_linear=True, trunc_dist=63,
                           refinement="vfit", median_radius=1),
    # BASELINE cfg3: satellite pairs (README.txt:107-108)
    "satellite": MGMConfig(dmin=-22, dmax=19, ndir=8, mgm=3,
                           distance="census", census_ncc_win=5,
                           refinement="vfit", median_radius=1),
    # full-accuracy: every direction incl. the 22.5-degree passes the
    # reference advertises but crashes on
    "full_16dir": MGMConfig(ndir=16, mgm=4, distance="census", p1=2,
                            p2=20000, use_trunc_linear=True,
                            refinement="vfit", median_radius=1),
    # NCC matching for radiometrically varying pairs
    "ncc": MGMConfig(ndir=8, mgm=2, distance="ncc", census_ncc_win=5,
                     refinement="vfit"),
    # Birchfield-Tomasi sampling-insensitive matching
    "bt": MGMConfig(ndir=8, mgm=2, distance="btad", refinement="parabola"),
}


def get_preset(name: str, **overrides) -> MGMConfig:
    """Fetch a preset, optionally overriding fields (e.g. dmin/dmax)."""
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
