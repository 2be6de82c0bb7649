"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload cfg1.pair --seed 7 --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics, from the untraced
window and one torch.profiler window after it), device, with --trace 1
a breakdown, the card's power limit, and last the check: each number
compared beside its limit (also the last lines of standard error).  Without a CUDA card, or with fewer than
the cell asks for, it prints no result and exits 2; if jax, jaxlib,
flax or mgm_tpu was loaded, it exits 3.
"""
from __future__ import annotations

import os
import time

T_TOP = time.perf_counter()


def _age() -> float:
    """Seconds since this process started, by /proc (0 where there is
    none)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = T_TOP - _age()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "mgm_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (mgm_tpu_torch is not mgm_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    chips = spec.cell(ROOT, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     device="cuda", started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded {found}: the benchmark may not run them",
              file=sys.stderr)
        return 3
    dev = result["device"]
    result["device"] = dict(platform="gpu",
                            kind=torch.cuda.get_device_name(0), count=chips,
                            **dev)
    check = result.pop("check")
    result["card"] = _power_limit()
    result["check"] = check
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder: the folder's modules (trace,
    # work, ...) would shadow others of those names
    sys.path[0] = str(ROOT)
    sys.exit(main())
