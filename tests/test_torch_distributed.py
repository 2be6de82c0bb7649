"""Row sharding across processes (mgm_tpu_torch.parallel.distributed):
two gloo processes on the CPU must reproduce the single-process result
bitwise, as tests/test_distributed.py holds mgm_tpu's two processes:
the A/B stagger at 4 directions, at 8 the V group's lockstep blocks,
whose apron refreshes send a ring's rows and their minima together, and
NCC at 8 (the dense mesh path: K5 on a band's halo tracks and the
column bands' pieces for the row bands).

The test starts two interpreters on this file itself (the block under
__main__ is the worker): each joins a two-process group on a localhost
port, runs compute_disparity_distributed on the same small problem and
then the mgm CLI over the processes' row mesh, where only process 0
writes.
"""
import os
import socket
import subprocess
import sys

import numpy as np

H, W = 32, 37


def _problem(ndir=4, distance="ad"):
    from mgm_tpu_torch import MGMConfig

    rng = np.random.default_rng(7)
    u = rng.uniform(0, 60, (H, W, 1)).astype(np.float32)
    v = (np.roll(u, 2, axis=1)
         + rng.normal(0, 0.5, (H, W, 1)).astype(np.float32))
    cfg = MGMConfig(dmin=-5, dmax=2, ndir=ndir, mgm=2, refinement="vfit",
                    median_radius=1, test_lr=True, distance=distance)
    return u, v, cfg


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_equals_single(tmp_path):
    _two_processes(tmp_path, 4)


def test_two_process_lockstep_groups(tmp_path):
    _two_processes(tmp_path, 8)


def test_two_process_dense(tmp_path):
    """NCC at ndir 8: the dense mesh path, whose halo tracks and column
    band pieces (RowMesh.cols_to_rows) go between the processes."""
    _two_processes(tmp_path, 8, "ncc")


def _two_processes(tmp_path, ndir, distance="ad"):
    from mgm_tpu_torch import compute_disparity
    from mgm_tpu_torch.io import read_image, write_image

    from test_torch_kernels import assert_bitwise

    u, v, cfg = _problem(ndir, distance)
    write_image(str(tmp_path / "u.tif"), u)
    write_image(str(tmp_path / "v.tif"), v)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    workers = [subprocess.Popen(
        [sys.executable, __file__, str(pid), "2", str(port), str(tmp_path),
         str(ndir), distance],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    try:
        outs = [w.communicate(timeout=120)[0] for w in workers]
    finally:
        for w in workers:
            w.kill()
    for pid, (w, o) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker {pid} failed:\n{o[-4000:]}"
        assert f"WORKER_OK {pid}" in o

    ref = compute_disparity(u, v, cfg, device="cpu")
    for pid in range(2):
        got = np.load(tmp_path / f"proc{pid}.npz")
        assert sorted(got.files) == sorted(ref)
        for k in ref:
            assert_bitwise(got[k], ref[k])
    # the CLI over the mesh: process 0 writes, process 1 does not
    assert_bitwise(read_image(str(tmp_path / "disp0.tif"))[..., 0],
                   ref["disp"])
    assert not (tmp_path / "disp1.tif").exists()


def _worker(pid: int, nprocs: int, port: str, outdir: str, ndir: int,
            distance: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from mgm_tpu_torch.cli import main as cli_main
    from mgm_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", nprocs, pid)
    assert dist.get_backend() == "gloo"
    u, v, cfg = _problem(ndir, distance)
    out = distributed.compute_disparity_distributed(u, v, cfg,
                                                    device="cpu")
    np.savez(os.path.join(outdir, f"proc{pid}.npz"), **out)
    os.environ.update(TSGM="2", MEDIAN="1")
    rc = cli_main(["-r", "-5", "-R", "2", "-O", str(ndir), "-s", "vfit",
                   "-t", distance, os.path.join(outdir, "u.tif"),
                   os.path.join(outdir, "v.tif"),
                   os.path.join(outdir, f"disp{pid}.tif")],
                  mesh=distributed.global_row_mesh("cpu"))
    dist.barrier()
    dist.destroy_process_group()
    assert rc == 0
    print("WORKER_OK", pid, flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            int(sys.argv[5]), sys.argv[6])
