"""The readings the limits of the output check are set from (chip only).

    python3 benchmark/calibrate.py --workload cfg1.pair \
        --seeds 11 12 ... --control-seeds 21 22 23 --seconds 3

runs, in one process, the cell as run.py does (short windows at the
cell's own load, every sampled request compared with the reference) on
each of `--seeds`, and then the control on each of `--control-seeds`:
the reference itself, computed in bfloat16 (the precision below the
float32 the configuration states), put in the program's place.  Prints
one JSON line a run with its numbers, and last the lower reading of
each number (the largest over the program's seeds) and the upper one
(the smallest over the control's).  limits/<cell>.json is set between
them as PERF.md says; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(config: dict, device):
    """The reference in bfloat16 as a serve function."""
    import torch

    from benchmark import spec

    ref = spec.module(ROOT, "reference", config["reference"])

    def serve(us, vs):
        with torch.no_grad():
            r = ref.disparity(us, vs, config["settings"], device=device,
                              dtype=torch.bfloat16)
        return r["disp"], r["cost"]
    return serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = {"program": [], "control": []}
    for side, seeds, serve in (("program", args.seeds, None),
                               ("control", args.control_seeds, control)):
        for seed in seeds:
            t = time.perf_counter()
            res, _ = harness.run_cell(ROOT, args.workload, seed,
                                      args.seconds, False, device="cuda",
                                      started=t, serve=serve)
            nums = {k: v["value"] for k, v in res["check"].items()}
            readings[side].append(nums)
            print(json.dumps(dict(side=side, seed=seed, requests=res[
                "attempted"], seconds=time.perf_counter() - t, **nums)),
                flush=True)
    names = readings["program"][0].keys()
    print(json.dumps(dict(
        workload=args.workload,
        lower={k: max(r[k] for r in readings["program"]) for k in names},
        upper={k: min(r[k] for r in readings["control"]) for k in names})))
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder: the folder's modules (trace,
    # work, ...) would shadow others of those names
    sys.path[0] = str(ROOT)
    sys.exit(main())
