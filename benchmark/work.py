"""The work of a request, counted from the cell's shapes alone, so that it
reads the same whatever implements it.

Throughput counts MP*disp: 2*H*W*L a pair (both LR sides; one without
the LR check), L the global label range, as the reference baseline
does (BASELINE.md: 5.8 MP*disp/s for cfg1 on one Xeon core).

The solve layer's roofline counts what the inputs need:
  operations (float32): each pass's message updates at every cell
    (pixel x label) of every side, a message 6 operations a label, the
    TSGM sum and division `mgm` more and the cost's add one more; on the
    fused branch (every cost but NCC, whose volume is a layer of its
    own) also the cost of each cell once: 3 operations a channel, the
    truncation and the window;
  bytes: the layer's inputs read once and its outputs (each side's
    disparity and cost, float32) written once; the inputs are the
    float32 images of the pair (fused branch) or each side's float32
    cost volume (dense branch); constant windows and no edge weights
    add nothing.
The least time is the larger of ops / F32_OPS and bytes / HBM_BPS: the
published peaks of one H100 SXM (NVIDIA's data sheet) at its full
700 W; the benchmark prints the card's power limit beside it.
"""
from __future__ import annotations

F32_OPS = 67e12      # float32 operations a second, outside the tensor cores
HBM_BPS = 3.35e12    # device memory bytes a second


def label_range(settings: dict) -> int:
    """L: the one global label axis both LR sides share (one iteration,
    constant windows)."""
    return settings["dmax"] - settings["dmin"] + 1


def sides(settings: dict) -> int:
    return 2 if settings.get("test_lr", True) else 1


def pair_mpdisp(config: dict) -> float:
    """MP*disp of one pair."""
    s = config["settings"]
    return (sides(s) * config["height"] * config["width"] * label_range(s)
            / 1e6)


def solve_work(config: dict) -> tuple[float, float]:
    """(float32 operations, bytes) of the solve layer for one pair."""
    s = config["settings"]
    H, W, C = config["height"], config["width"], config["channels"]
    N, L, mgm = sides(s), label_range(s), s["mgm"]
    cells = N * H * W * L
    ops = s["ndir"] * cells * (6 * mgm + mgm + 1)
    outputs = N * 2 * H * W * 4
    if s["distance"] == "ncc":
        inputs = cells * 4
    else:
        ops += cells * (3 * C + 2)
        inputs = 2 * H * W * C * 4
    return float(ops), float(inputs + outputs)


def solve_bound_s(config: dict, pairs: int) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of the solve layer for
    `pairs` pairs at the published peaks."""
    ops, nbytes = solve_work(config)
    t_ops, t_bytes = pairs * ops / F32_OPS, pairs * nbytes / HBM_BPS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
