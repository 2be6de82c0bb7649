"""Whole runs of each cell on the CPU at a tiny size (the harness's look
for a card skipped, the port's plain kernels in the window): sound runs
come out correct under the committed limits, and runs whose timed path
is broken underneath, or the control put in the program's place, come
out not correct."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import harness, spec
from benchmark.tests._tiny import REPO, tiny_root

CELLS = [w["name"] for w in spec.load(REPO)["workloads"]]


def _run(root, cell, serve=None, seed=2**33 + 11):
    res, lines = harness.run_cell(root, cell, seed, 0.3, False,
                                  device="cpu", started=time.perf_counter(),
                                  serve=serve)
    assert len(lines) == len(res["check"]) == 2
    return res


def _wrap(root, cell, change):
    """A serve factory: the cell's own entry with `change` applied to
    each request's (us, vs, serve) -> (disp, cost)."""
    entry = spec.module(root, "entries",
                        spec.cell(root, cell)["traffic"]["entry"])

    def make(config, device):
        serve = entry.make(config, device)
        return lambda us, vs: change(us, vs, serve)
    return make


@pytest.fixture
def root(tmp_path):
    return tiny_root(tmp_path)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(root, cell):
    def change(us, vs, serve):
        disp, cost = serve(us, vs)
        disp = disp.copy()
        disp[0] += 1.0
        return disp, cost
    assert not _run(root, cell, _wrap(root, cell, change))["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cost_altered_where_it_is_produced(root, cell):
    def change(us, vs, serve):
        disp, cost = serve(us, vs)
        cost = cost.copy()
        cost[0] *= 1.01
        return disp, cost
    assert not _run(root, cell, _wrap(root, cell, change))["correct"]


def test_half_of_the_batch_left_out(root):
    def change(us, vs, serve):
        h = len(us) // 2
        disp, cost = serve(us[:h], vs[:h])
        return np.concatenate([disp, disp]), np.concatenate([cost, cost])
    assert not _run(root, "cfg1.b8", _wrap(root, "cfg1.b8", change))[
        "correct"]


@pytest.mark.parametrize("cell", ["cfg1.pair", "cfg1.b8"])
def test_the_fused_recursion_leaves_its_state_unchanged(root, cell,
                                                        monkeypatch):
    from mgm_tpu_torch.ops import cuda_fused

    def unchanged(left, right, out, **kw):
        if not kw["accumulate"]:
            out.zero_()
    monkeypatch.setattr(cuda_fused, "fused_wavefront", unchanged)
    assert not _run(root, cell)["correct"]


def test_the_dense_recursion_returns_its_input(root, monkeypatch):
    from mgm_tpu_torch.ops import wavefront

    def unchanged(cc, w8=None, lo=None, hi=None, *, maps, **kw):
        return cc[None].expand(len(maps), *cc.shape).clone()
    monkeypatch.setattr(wavefront, "wavefront_scan", unchanged)
    assert not _run(root, "ncc.pair")["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    """The reference in bfloat16, the precision below the float32 the
    configurations state, in the program's place."""
    ref = spec.module(root, "reference", "mgm")

    def make(config, device):
        def serve(us, vs):
            r = ref.disparity(us, vs, config["settings"], device=device,
                              dtype=torch.bfloat16)
            return r["disp"], r["cost"]
        return serve
    assert not _run(root, cell, make)["correct"]
