"""Row sharding across processes over torch.distributed (counterpart
of mgm_tpu/parallel/distributed.py): one rank a process, each process
driving its own device, the boundary tracks and the gathered maps sent
between processes.

    python -m mgm_tpu_torch.parallel.distributed \\
        --coordinator HOST0:9911 --num-processes 2 --process-id $ID \\
        -r -120 -R 30 -O 4 left.png right.png out_disp.tif

runs the mgm CLI with the row mesh of every process (the same command
on each, one --process-id each); process 0 writes the outputs.

The backend is NCCL when every process has a card of its own, gloo
otherwise.  NCCL refuses two ranks on one GPU, so several processes on
one card take gloo, whose point-to-point and collectives take CPU
tensors only (PyTorch's backend table): the tracks then go through
host memory (shard._staged).  That is not a fallback: a group with
NCCL across distinct cards sends the device tensors.
"""
from __future__ import annotations

import os

import torch

from .shard import RowMesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """torch.distributed.init_process_group over tcp://`coordinator`
    (host:port) with MGM_TPU_COORDINATOR / MGM_TPU_NUM_PROCS /
    MGM_TPU_PROC_ID as the fallbacks.  The backend is NCCL when the
    host has a card for every process (as many CUDA devices as
    processes), else gloo."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("MGM_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("MGM_TPU_NUM_PROCS"):
        num_processes = int(os.environ["MGM_TPU_NUM_PROCS"])
    if process_id is None and os.environ.get("MGM_TPU_PROC_ID"):
        process_id = int(os.environ["MGM_TPU_PROC_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator, the process "
                         "count and this process's id (or MGM_TPU_"
                         "COORDINATOR / _NUM_PROCS / _PROC_ID)")
    own = (torch.cuda.is_available()
           and torch.cuda.device_count() >= num_processes)
    dist.init_process_group("nccl" if own else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_row_mesh(device=None) -> RowMesh:
    """The 1-D row mesh of every process, one rank a process in process
    order, this process driving its own.  Under NCCL process k takes
    cuda:k mod the host's card count; under gloo `device` (default: the
    card, "cuda")."""
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    if dist.get_backend() == "nccl":
        count = torch.cuda.device_count()
        devices = [f"cuda:{k % count}" for k in range(n)]
    else:
        devices = [device or "cuda"] * n
    return RowMesh(devices, local=[rank], group=dist.group.WORLD)


def compute_disparity_distributed(u, v, cfg, *, device=None, **kw):
    """Row-sharded compute_disparity over the global mesh: every process
    passes the same full images (megabytes) and receives the full
    outputs; the volumes are sharded across the processes.  `initialize`
    comes first."""
    from ..stereo import compute_disparity

    return compute_disparity(u, v, cfg, mesh=global_row_mesh(device), **kw)


def main(argv=None, device=None) -> int:
    """The mgm CLI over the processes' row mesh: --coordinator,
    --num-processes and --process-id, then the mgm flags and files;
    process 0 writes the outputs."""
    import sys

    import torch.distributed as dist

    from ..cli import main as cli_main, pick_option

    argv = list(sys.argv[1:] if argv is None else argv)
    coord = pick_option(argv, "-coordinator", None)
    nproc = pick_option(argv, "-num-processes", None)
    pid = pick_option(argv, "-process-id", None)
    initialize(coord, int(nproc) if nproc else None,
               int(pid) if pid else None)
    try:
        rc = cli_main(argv, mesh=global_row_mesh(device))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
