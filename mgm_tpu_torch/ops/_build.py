"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `mgm_tpu_torch/csrc/*.cu` goes into ONE shared library with a
plain C interface (no PyTorch headers, so nvcc takes seconds): one
nvcc call a source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         --fmad=false -Xcompiler -fPIC -Xptxas=-v -c -o x.o csrc/x.cu
    nvcc -shared -o lib.so *.o

`--fmad=false` and no fast math keep the kernels' float arithmetic
operation-for-operation equal to their plain PyTorch versions.  The
library lands in `mgm_tpu_torch/_build/<hash>/`, keyed by a hash of
the sources and the flags; it is written to a temporary name and
renamed, so concurrent builds never see a partial file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmgm_kernels.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc process a source, all at once, then the link.  The
    compiler's report (registers, spills) is kept in build.log."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(s)]
                for s, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        out = os.path.join(tmp, lib.name)
        link = [nvcc, "-shared", "-o", out, *objs]
        for cmd, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(link)}\n{res.stdout}"
                               f"{res.stderr}")
        (lib.parent / "build.log").write_text("".join(logs))
        # a rename, so concurrent builds never see a partial file
        os.replace(out, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built if it does not exist yet."""
    return ctypes.CDLL(str(build()))
