"""Drop-in replacement for the reference `mgm_o` MRF-solver binary
(counterpart of mgm_tpu/mrf_cli.py), on the GPU by default.

Binary protocol (matlab/mgm_o.cc:509-609 + MGM_wrapper.m:83-108):
input.bin  = int32 {ncol, nrow, nlab, NDIR}
           + float32 lcosts[ncol*nrow*nlab]   (label-major planes,
             lcosts[i + o*ncol*nrow] = cost of label o at pixel i)
           + float32 edge_w[ncol*nrow*8]      (8 planes W,E,S,N,NW,NE,SE,SW)
output.bin = float32 labels[ncol*nrow]

    python -m mgm_tpu_torch.mrf_cli input.bin labeling.bin [P1 P2 MGM VTYPE]
    mgm-tpu-torch-o input.bin labeling.bin [P1 P2 MGM VTYPE]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .mrf import solve_mrf

USAGE = """   usage: mgm_o input.bin labeling.bin [P1  P2  MGM  VTYPE]
       P1 & P2 : regularization parameters (default values: 8 & 32)
       MGM     : mgm directions: 1 (SGM), 2 (default), or 4
       VTYPE   : V potential: 0(SGM's, default), 1(truncated linear)
"""


def read_problem(path: str):
    with open(path, "rb") as f:
        ncol, nrow, nlab, ndir = np.fromfile(f, dtype=np.int32, count=4)
        lcosts = np.fromfile(f, dtype=np.float32, count=ncol * nrow * nlab)
        edge_w = np.fromfile(f, dtype=np.float32, count=ncol * nrow * 8)
    # plane-major -> (H, W, L) / (H, W, 8)
    unary = lcosts.reshape(nlab, nrow, ncol).transpose(1, 2, 0)
    w8 = edge_w.reshape(8, nrow, ncol).transpose(1, 2, 0)
    return unary, w8, int(ndir)


def write_problem(path: str, unary: np.ndarray, w8: np.ndarray,
                  ndir: int = 8) -> None:
    """The inverse of read_problem: unary (H, W, L) and w8 (H, W, 8) in
    the protocol's plane-major layout."""
    nrow, ncol, nlab = unary.shape
    with open(path, "wb") as f:
        np.array([ncol, nrow, nlab, ndir], np.int32).tofile(f)
        np.ascontiguousarray(unary.transpose(2, 0, 1), np.float32).tofile(f)
        np.ascontiguousarray(w8.transpose(2, 0, 1), np.float32).tofile(f)


def write_labels(path: str, labels: np.ndarray) -> None:
    np.asarray(labels, np.float32).tofile(path)


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        sys.stderr.write("too few parameters\n" + USAGE)
        return 1
    f_in, f_out = argv[0], argv[1]
    p1 = float(argv[2]) if len(argv) > 2 else 8.0
    p2 = float(argv[3]) if len(argv) > 3 else 32.0
    mgm = int(argv[4]) if len(argv) > 4 else 2
    vtype = int(argv[5]) if len(argv) > 5 else 0

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch kernels on the CPU")
    unary, w8, ndir = read_problem(f_in)
    labels = solve_mrf(unary, ndir=ndir, p1=p1, p2=p2, mgm=mgm, vtype=vtype,
                       weights=w8, device=device)
    write_labels(f_out, labels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
