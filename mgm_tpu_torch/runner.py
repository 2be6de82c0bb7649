"""Tiled large-scene runner with checkpoint/resume (counterpart of
mgm_tpu/runner.py).

The reference processes one image pair per invocation and keeps the
whole cost volume in RAM (mgm.cc:266-450 of gfacciol/mgm); satellite
pipelines built on it (s2p-style) tile big scenes into overlapping
crops and run the binary per tile.  This runner makes that pattern a
resumable library call: the scene is cut into tiles with a
`margin`-pixel context band, each tile solves on the device, the core
of each result is mosaicked into the scene arrays, and with
`checkpoint_dir` every finished tile is persisted (utils/checkpoint.py,
the JAX package's format) so a preempted job resumes at the first
unfinished tile.

The data term of a core pixel is exact: the right-image crop is
widened by [dmin, dmax] so every candidate correspondence is present.
Aggregation context is truncated at `margin` pixels (regularisation
influence decays with distance); a margin as large as the scene
reproduces the single-solve result exactly.  Every context window has
one shape, so the tiles of a tile row stack into compute_disparity_batch
calls.  The JAX runner's streamed upload/fetch pipeline is
transfer-layer code for a remote-attached TPU and is not ported.

    mgm-tpu-torch-tiled left right out_disp [out_cost] [options]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import MGMConfig
from .stereo import compute_disparity, compute_disparity_batch
from .utils.checkpoint import load_state, save_state


# device bytes a batched solve holds per (side, context pixel, label):
# the K1 volume of up to five spaces, the space sum, and the leftover
# branch's dense volumes (a satellite pair takes about 13,
# chip_smoke.py phase 22); a batch takes at most half the free memory
_BYTES_A_CELL = 48


def _tile_starts(size: int, tile: int) -> list[int]:
    return list(range(0, size, tile)) if size else [0]


def _row_batch(cfg: MGMConfig, n_row: int, ctx_h: int, ctx_w: int,
               device) -> int:
    """Tiles a batched solve takes: a whole tile row, as far as half the
    card's free memory holds it (on the CPU the whole row)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return n_row
    free, _ = torch.cuda.mem_get_info(dev)
    n_sides = 2 if cfg.test_lr else 1
    tile_bytes = (_BYTES_A_CELL * n_sides * ctx_h * ctx_w
                  * (cfg.dmax - cfg.dmin + 1))
    return max(1, min(n_row, free // (2 * tile_bytes)))


def tiled_disparity(u: np.ndarray, v: np.ndarray, cfg: MGMConfig,
                    tile: int = 512, margin: int = 64,
                    checkpoint_dir: str | None = None,
                    verbose: bool = False,
                    dmin_img: np.ndarray | None = None,
                    dmax_img: np.ndarray | None = None,
                    batch: int | None = None, *, device="cuda",
                    mesh=None) -> dict:
    """Solve a (H, W, C) scene pair tile by tile on `device`.

    Returns {'disp', 'cost'} scene-sized float32 arrays (left side) and
    'tiles_solved', the number of tiles solved in this call.
    `tile`: core tile size (pixels, both axes).  `margin`: context
    pixels added on every tile side before solving (cropped off after).
    `checkpoint_dir`: persist each finished tile and skip tiles already
    present (resume after preemption).  `dmin_img`/`dmax_img`: scene
    per-pixel disparity windows (-m/-M), cropped per tile; they solve
    tile by tile.  Otherwise the tiles of one tile row solve together in
    compute_disparity_batch calls of `batch` tiles, by default as many
    as the row has and half the card's free memory holds.  `mesh` (a
    parallel.RowMesh) shards each tile's solve over its ranks' rows, one
    tile at a time (mgm_tpu/runner.py:63)."""
    H, W, _ = u.shape
    if v.shape != u.shape:
        raise ValueError(f"rectified pairs share geometry: {u.shape} and "
                         f"{v.shape}")
    pad_l, pad_r = max(0, -cfg.dmin), max(0, cfg.dmax)
    disp = np.full((H, W), np.nan, np.float32)
    cost = np.full((H, W), np.nan, np.float32)
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    # context window: margin all around, plus the disparity search band
    # on the column axis so every candidate right pixel of a core left
    # pixel is inside the crop; ONE shape for every tile, shifted inward
    # at scene edges (extra context there, never less), so tiles stack
    # into batches
    ctx_h = min(H, tile + 2 * margin)
    ctx_w = min(W, tile + 2 * margin + pad_l + pad_r)
    if dmin_img is not None or mesh is not None:
        batch = 1
    elif batch is None:
        batch = _row_batch(cfg, len(_tile_starts(W, tile)), ctx_h, ctx_w,
                           device)

    # pending tile jobs (checkpointed ones are loaded up front), grouped
    # into batches that never straddle tile rows
    groups, cur = [], []
    n_solved = 0
    for y0 in _tile_starts(H, tile):
        for x0 in _tile_starts(W, tile):
            y1, x1 = min(y0 + tile, H), min(x0 + tile, W)
            ckpt = (os.path.join(checkpoint_dir, f"tile_{y0}_{x0}.npz")
                    if checkpoint_dir else None)
            state = load_state(ckpt) if ckpt else None
            if state is not None:
                disp[y0:y1, x0:x1] = state["disp"]
                cost[y0:y1, x0:x1] = state["cost"]
                continue
            if cur and (cur[0][0] != y0 or len(cur) == batch):
                groups.append(cur)
                cur = []
            cy0 = min(max(0, y0 - margin), H - ctx_h)
            cx0 = min(max(0, x0 - margin - pad_l), W - ctx_w)
            cur.append((y0, x0, y1, x1, slice(cy0, cy0 + ctx_h),
                        slice(cx0, cx0 + ctx_w), ckpt))
    if cur:
        groups.append(cur)

    for grp in groups:
        crops = [(job[4], job[5]) for job in grp]
        if dmin_img is not None or mesh is not None:
            win = {} if dmin_img is None else dict(
                dmin_img=dmin_img[crops[0]], dmax_img=dmax_img[crops[0]])
            res = compute_disparity(
                u[crops[0]], v[crops[0]], cfg, device=device,
                outputs=("disp", "cost"), mesh=mesh, **win)
            res = {k: a[None] for k, a in res.items()}
        else:
            res = compute_disparity_batch(
                np.stack([u[c] for c in crops]),
                np.stack([v[c] for c in crops]), cfg, device=device,
                outputs=("disp", "cost"))
        for k, (y0, x0, y1, x1, rows, cols, ckpt) in enumerate(grp):
            core = (slice(y0 - rows.start, y1 - rows.start),
                    slice(x0 - cols.start, x1 - cols.start))
            td, tc = res["disp"][k][core], res["cost"][k][core]
            disp[y0:y1, x0:x1] = td
            cost[y0:y1, x0:x1] = tc
            n_solved += 1
            if ckpt:
                save_state(ckpt, disp=td, cost=tc)
            if verbose:
                print(f"[tile] ({y0},{x0})..({y1},{x1}) solved", flush=True)
    return {"disp": disp, "cost": cost, "tiles_solved": n_solved}


def main(argv=None, *, device="cuda") -> int:
    """CLI: mgm-tpu-torch-tiled left right out_disp [out_cost] [options]
    (the options of mgm_tpu.runner.main).  Runs on one
    CUDA device; main(argv, device="cpu") runs the plain PyTorch
    versions of the kernels instead."""
    from .io import read_image, write_image
    from .models.presets import get_preset

    ap = argparse.ArgumentParser(
        prog="mgm-tpu-torch-tiled",
        description="Tiled, resumable large-scene stereo (preset-based)")
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("out_disp")
    ap.add_argument("out_cost", nargs="?")
    ap.add_argument("--preset", default="fast_ad")
    ap.add_argument("-r", "--dmin", type=int, default=-30)
    ap.add_argument("-R", "--dmax", type=int, default=30)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--margin", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (enables resume)")
    ap.add_argument("-m", "--dmin-img", default=None,
                    help="per-pixel minimum disparity image")
    ap.add_argument("-M", "--dmax-img", default=None,
                    help="per-pixel maximum disparity image")
    args = ap.parse_args(argv)

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch kernels on the CPU")
    cfg = get_preset(args.preset, dmin=args.dmin, dmax=args.dmax)
    u, v = read_image(args.left), read_image(args.right)
    dmin_img = (read_image(args.dmin_img)[..., 0]
                if args.dmin_img else None)
    dmax_img = (read_image(args.dmax_img)[..., 0]
                if args.dmax_img else None)
    res = tiled_disparity(u, v, cfg, tile=args.tile, margin=args.margin,
                          checkpoint_dir=args.ckpt, verbose=True,
                          dmin_img=dmin_img, dmax_img=dmax_img,
                          device=device)
    write_image(args.out_disp, res["disp"])
    if args.out_cost:
        write_image(args.out_cost, res["cost"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
