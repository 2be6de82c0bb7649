"""Nothing a run of the benchmark loads is JAX or the JAX package, and
the reference loads nothing of the program: each checked in a fresh
interpreter, by whole top-level module names."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests._tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "mgm_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of the modules loaded after running `code`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", [w["name"]
                                  for w in spec.load(REPO)["workloads"]])
def test_a_cell_loads_no_jax(cell):
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from benchmark import harness, run, spec, traffic
c = spec.cell(spec.Path({str(REPO)!r}), {cell!r})
serve = spec.module(run.ROOT, "entries", c["traffic"]["entry"]).make(
    c["config"], "cpu")
spec.module(run.ROOT, "reference", c["config"]["reference"])
for m in c["end_to_end"] + c["per_layer"]:
    spec.reader(run.ROOT, m)
"""
    loaded = _loaded(code)
    assert "mgm_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from benchmark.reference import mgm
from benchmark import check, traffic, work
""")
    assert not loaded & (FORBIDDEN | {"mgm_tpu_torch"})


def test_run_names_forbidden_modules_by_whole_name(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "mgm_tpu_torch_probe", sys)
    assert "mgm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mgm_tpu.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"mgm_tpu", "jaxlib"} <= set(run.forbidden_modules())
