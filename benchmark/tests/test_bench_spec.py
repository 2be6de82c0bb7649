"""BENCHMARK.json keeps to the benchmark's format, and a cell, a
configuration and a per-layer metric are added by adding files and
entries alone."""
from __future__ import annotations

import json
import re
import time

import pytest

from benchmark import harness, spec
from benchmark.tests._tiny import REPO, edit_json, tiny_root

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_format():
    b = spec.load(REPO)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(map(_line, b["command"]))
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    assert len(configs) == len(b["configs"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"])
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == []
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and _line(w["why"])
        assert spec.data_file(REPO, "traffic", w["traffic"]).is_file()
        assert spec.data_file(REPO, "limits", w["name"]).is_file()
    assert {w["config"] for w in b["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = set(e2e)
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert _line(m["layer"]) and set(m["workloads"]) <= set(cells)
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert spec.data_file(REPO, "metrics", m["name"]).is_file()
    for w in cells:
        c = spec.cell(REPO, w)
        got = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2 and c["per_layer"]


def test_cell_metric_and_config_added_as_files(tmp_path):
    """A new configuration, traffic, cell and per-layer metric (with a
    reader of its own) are picked up from their files alone, and a run
    of the new cell reports the new metric."""
    root = tiny_root(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "cfg1.json").read_text())
    cfg.update(name="cfg1_tsgm1")
    cfg["settings"]["mgm"] = 1
    (bench / "configs" / "cfg1_tsgm1.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "pair.json").read_text())
    traffic.update(pool_pairs=2, warmup_requests=1, check_requests=2)
    (bench / "traffic" / "pair2.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cfg1_tsgm1.pair2.json").write_text(
        (bench / "limits" / "cfg1.pair.json").read_text())
    (bench / "readers" / "pool_scaled.py").write_text(
        "def read(run, scale):\n"
        "    return run.traffic['pool_pairs'] * scale if run.trace else None\n")
    (bench / "metrics" / "pool_pairs_x2.json").write_text(
        json.dumps({"reader": "pool_scaled", "scale": 2}))

    def add(b):
        b["configs"].append(dict(name="cfg1_tsgm1", source="test",
                                 file="benchmark/configs/cfg1_tsgm1.json",
                                 reduced=[], why="test"))
        b["workloads"].append(dict(name="cfg1_tsgm1.pair2",
                                   config="cfg1_tsgm1", traffic="pair2",
                                   chips=1, why="test"))
        b["per_layer"].append(dict(name="pool_pairs_x2", unit="count",
                                   better="higher", source="host_clock",
                                   layer="entry", moves="throughput_mpds",
                                   workloads=["cfg1_tsgm1.pair2"]))
    edit_json(root / "BENCHMARK.json", add)

    c = spec.cell(root, "cfg1_tsgm1.pair2")
    assert c["config"]["settings"]["mgm"] == 1
    assert c["traffic"]["pool_pairs"] == 2
    assert [m["name"] for m in c["per_layer"]] == ["pool_pairs_x2"]
    res, lines = harness.run_cell(root, "cfg1_tsgm1.pair2", 5, 0.2, True,
                                  device="cpu", started=time.perf_counter())
    assert res["correct"] and lines
    assert res["metrics"]["pool_pairs_x2"]["value"] == 4


@pytest.mark.parametrize("bad", ["../x", "a/b", "", ".hidden", "a b"])
def test_names_are_not_paths(bad):
    with pytest.raises(ValueError):
        spec.data_file(REPO, "traffic", bad)
