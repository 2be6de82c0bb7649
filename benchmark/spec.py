"""BENCHMARK.json and the files it names, found by name under a root.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, so a cell, a configuration or a per-layer
metric is added by adding files and entries:

  BENCHMARK.json                   the cells, their configurations and
                                   the metrics, with bounds and layers
  benchmark/configs/<config>.json  settings, geometry, data, reference
  benchmark/traffic/<traffic>.json entry, pairs a request, pool, warm-up
  benchmark/limits/<cell>.json     the limits of the output check
  benchmark/metrics/<metric>.json  the reader of a metric and its data
  benchmark/readers/<reader>.py    read(run, **data) -> value or None
  benchmark/entries/<entry>.py     make(config, device) -> serve
  benchmark/reference/<ref>.py     disparity(us, vs, settings, ...)
  benchmark/kernels.json           kernel name prefixes by group
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
DIR = "benchmark"


def _name(n) -> str:
    """A name as the benchmark allows it, and never a path."""
    if not isinstance(n, str) or not NAME.fullmatch(n) or ".." in n:
        raise ValueError(f"not a benchmark name: {n!r}")
    return n


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load(root: Path) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def data_file(root: Path, kind: str, name: str) -> Path:
    """benchmark/<kind>/<name>.json under root."""
    return Path(root) / DIR / kind / f"{_name(name)}.json"


def module(root: Path, kind: str, name: str):
    """The module benchmark/<kind>/<name>.py under root, loaded from its
    file, so that a copy of the benchmark uses its own files."""
    path = Path(root) / DIR / kind / f"{_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(root: Path, workload: str) -> dict:
    """The cell named `workload` with everything it needs: its entry in
    BENCHMARK.json, its configuration, traffic and limits, and the
    metrics it reports: every end-to-end metric, and the per-layer
    metrics whose `workloads` name it."""
    root = Path(root)
    bench = load(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in {root / 'BENCHMARK.json'}")
    c = cells[_name(workload)]
    configs = {x["name"]: x for x in bench["configs"]}
    config = read_json(root / configs[c["config"]]["file"])
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return dict(chips=c["chips"], config=config,
                traffic=read_json(data_file(root, "traffic", c["traffic"])),
                limits=read_json(data_file(root, "limits", workload)),
                end_to_end=bench["end_to_end"], per_layer=layer,
                kernels=read_json(root / DIR / "kernels.json"))


def reader(root: Path, metric: dict):
    """(read function, its data) of a metric's entry."""
    data = read_json(data_file(root, "metrics", metric["name"]))
    name = data.pop("reader")
    return module(root, "readers", name).read, data
