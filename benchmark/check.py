"""The comparison that decides `correct`: the program's disparity and cost
maps of every sampled request against the plain reference's maps of
the same pairs.

Two numbers, each the worst over the sampled pairs (a pair judged on
its own, so one altered answer shows whole):
  mismatch  the share of a pair's pixels whose disparity differs by
            more than DISP_TOL pixels or is NaN on one side only (the
            LR check's verdict), or whose cost differs by more than
            COST_TOL of the reference's or is finite on one side only;
  cost_gap  the largest |cost - reference cost| / max(|reference
            cost|, 1) over the pixels that agree on the disparity and
            have finite costs on both sides (a widest gap: a near-tie
            that the two sides break apart under vfit moves it alone).
Each has its limit, set per cell in limits/<cell>.json from the
readings that PERF.md gives.
"""
from __future__ import annotations

import numpy as np

# a disparity is the same within this many pixels: the refined
# disparities of sound runs differ by rounding (about 1e-6 px), a
# different label by 1 px or by a fraction of the refinement
DISP_TOL = 0.05
# a cost is the same within this share: sound runs differ by float32
# rounding of sums taken in another order (about 4e-7 of the cost on
# the fused branch, 2e-4 under vfit), a bfloat16 solve by its 2**-9
COST_TOL = 1e-3


def compare_pair(disp, cost, ref_disp, ref_cost) -> dict:
    """The two numbers of one pair's (H, W) maps."""
    na, nb = np.isnan(disp), np.isnan(ref_disp)
    with np.errstate(invalid="ignore"):
        far = ~na & ~nb & ~(np.abs(disp - ref_disp) <= DISP_TOL)
    finite = np.isfinite(cost) & np.isfinite(ref_cost)
    with np.errstate(invalid="ignore"):
        gap = np.where(finite, np.abs(cost - ref_cost)
                       / np.maximum(np.abs(ref_cost), 1.0), 0.0)
    bad = ((na != nb) | far | (np.isfinite(cost) != np.isfinite(ref_cost))
           | (gap > COST_TOL))
    agree = ~((na != nb) | far) & finite
    return {"mismatch": float(bad.mean()),
            "cost_gap": float(gap[agree].max()) if agree.any() else 0.0}


def worst(pairs) -> dict:
    """The largest of each number over an iterable of compare_pair
    results."""
    out = {"mismatch": 0.0, "cost_gap": 0.0}
    for r in pairs:
        for k in out:
            out[k] = max(out[k], r[k])
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    lies at or below its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return all(numbers[k] <= limits[k] for k in numbers), shown
