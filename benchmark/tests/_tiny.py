"""A copy of the benchmark under a temporary root with every
configuration cut to a few pixels and labels, so that a test can drive
whole runs on the CPU (the port's plain kernels)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = dict(height=20, width=32, dmin=-8, dmax=3)


def tiny_root(tmp: Path, **size) -> Path:
    """BENCHMARK.json and benchmark/ copied under tmp, the
    configurations cut to `size` (TINY's keys)."""
    size = {**TINY, **size}
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in (tmp / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(height=size["height"], width=size["width"])
        cfg["settings"].update(dmin=size["dmin"], dmax=size["dmax"])
        path.write_text(json.dumps(cfg))
    return tmp


def edit_json(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))
