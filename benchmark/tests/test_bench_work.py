"""The work counts of benchmark/work.py against counts by hand, and the
readers that use them on a trace made by hand."""
from __future__ import annotations

import pytest

from benchmark import trace, work
from benchmark.harness import Run
from benchmark.tests._tiny import REPO
from benchmark.spec import module, read_json


def _cfg(distance, ndir, H=2, W=3, C=3, dmin=-1, dmax=0, lr=True):
    return dict(height=H, width=W, channels=C,
                settings=dict(dmin=dmin, dmax=dmax, ndir=ndir, mgm=2,
                              distance=distance, test_lr=lr))


def test_fused_counts_by_hand():
    # 2 sides x 2 x 3 pixels x 2 labels = 24 cells; 4 passes of
    # 2 messages (6 a label each), their sum and halving (2) and the
    # cost's add (1): 4 * 24 * 15; the AD cost once a cell: 3 a channel
    # + truncation + window = 11
    ops, nbytes = work.solve_work(_cfg("ad", 4))
    assert ops == 4 * 24 * 15 + 24 * 11
    # both float32 images read once (2 * 6 pixels * 3 channels * 4 B),
    # each side's disparity and cost written once (2 * 2 * 6 * 4 B)
    assert nbytes == 144 + 96
    assert work.pair_mpdisp(_cfg("ad", 4)) == pytest.approx(24e-6)
    assert work.solve_bound_s(_cfg("ad", 4), 3) == (
        pytest.approx(3 * 240 / work.HBM_BPS), "bytes")


def test_dense_counts_by_hand():
    # NCC: the volume is its own layer; 8 passes over the 24 cells, the
    # volumes read once (24 * 4 B) and the maps written once
    ops, nbytes = work.solve_work(_cfg("ncc", 8))
    assert ops == 8 * 24 * 15
    assert nbytes == 24 * 4 + 96


def test_one_side_without_lr_check():
    assert work.pair_mpdisp(_cfg("ad", 4, lr=False)) == pytest.approx(12e-6)


def test_cfg1_at_its_size():
    cfg = read_json(REPO / "benchmark" / "configs" / "cfg1.json")
    ops, _ = work.solve_work(cfg)
    cells = 2 * 500 * 700 * 151
    assert ops == cells * (4 * 15 + 11)
    t, by = work.solve_bound_s(cfg, 1)
    assert by == "operations" and t == pytest.approx(ops / 67e12)


def _run(trace_):
    cfg = _cfg("ad", 4)
    return Run(config=cfg, traffic=dict(pairs_per_request=2),
               kernels=dict(K1=["fused_wavefront_cluster"], K2=["wta_runs"],
                            copy=["Memcpy"]),
               setup_s=1.0, trace=trace_)


def test_readers_on_a_hand_made_trace():
    tr = trace.Trace(window_s=1.0, requests=4, device=[
        (0.0, 0.2, "fused_wavefront_cluster<0, 1>(WaveParams)"),
        (0.1, 0.3, "wta_runs(WtaParams)"),
        (0.5, 0.6, "Memcpy HtoD (Pageable -> Device)"),
        (0.7, 0.75, "elementwise_kernel"),
    ], host=[(0.0, 1.0, "request"), (0.3, 0.5, "aten::copy_")])
    run = _run(tr)
    rd = lambda name: module(REPO, "readers", name).read  # noqa: E731
    assert rd("device_ms")(run, kernels=["K1"]) == pytest.approx(50.0)
    assert rd("device_ms")(run, kernels=["copy"]) == pytest.approx(25.0)
    assert rd("other_device_ms")(run, exclude=["K1", "K2", "copy"]) == \
        pytest.approx(12.5)
    # busy: [0, 0.3] + [0.5, 0.6] + [0.7, 0.75] = 0.45 of 1 s
    assert trace.busy_s(tr) == pytest.approx(0.45)
    assert rd("idle_pct")(run) == pytest.approx(55.0)
    bound, _ = work.solve_bound_s(run.config, 2)
    assert rd("roofline")(run, kernels=["K1", "K2"]) == \
        pytest.approx(100 * bound / 0.1)
    assert rd("device_ms")(run, kernels=["K2"]) == pytest.approx(50.0)
    # step_mfu reads the untraced window, not the trace
    assert rd("mfu")(run) is None
    run.pairs, run.window_s = 6, 2.0
    assert rd("mfu")(run) == pytest.approx(
        100 * work.solve_work(run.config)[0] * 6 / (2.0 * work.F32_OPS))
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0].startswith("fused_wavefront_cluster")
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(0.2)
    assert gaps["request"] == pytest.approx(0.1 + 0.25)


def test_readers_find_nothing_without_a_trace():
    run = _run(None)
    for name, kw in (("device_ms", dict(kernels=["K1"])),
                     ("roofline", dict(kernels=["K1"])),
                     ("idle_pct", {})):
        assert module(REPO, "readers", name).read(run, **kw) is None
    empty = _run(trace.Trace(window_s=1.0, requests=1))
    assert module(REPO, "readers", "roofline").read(
        empty, kernels=["K1"]) is None
