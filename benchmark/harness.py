"""One run of one cell: set-up, the measured window, the output check and
the metrics, as a result dictionary (run.py prints it).

The window is a closed loop with one client: the next request goes out
when the previous one's numpy outputs are in hand, as in a pipeline
stage that waits for each solve.  It runs whole requests until
`seconds` have passed, so every request in it is complete and the
window's length is the time from the first request's call to the last
one's return.  Nothing compiles in it: the kernel library is built (or
found in the checkout's compile cache) and every shape of the cell is
served before the window starts.  A traced run measures the same
untraced window first and then a second one under torch.profiler, so
that what the host clock reads (the requests, the window's seconds) is
never the profiler's slower run.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, spec, trace
from .traffic import make_pool, request_groups


@dataclass
class Run:
    """What the readers read of one run: the untraced window's requests
    and seconds, and with --trace 1 the traced window's Trace."""
    config: dict
    traffic: dict
    kernels: dict
    setup_s: float
    latencies_s: list = field(default_factory=list)
    window_s: float = 0.0
    pairs: int = 0
    peak_bytes: int = 0
    trace: trace.Trace | None = None

    @property
    def requests(self) -> int:
        return len(self.latencies_s)

    def prefixes(self, groups) -> list:
        """The kernel name prefixes of kernels.json's groups."""
        return [p for g in groups for p in self.kernels[g]]


class _Sample:
    """A seeded uniform sample of k of the requests offered (reservoir
    sampling), so the check's cost does not grow with the window."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng([seed, 3])

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(fn, groups, us, vs, k: int, seconds: float, sample) -> tuple:
    """(latencies, seconds) of one closed-loop window of whole requests;
    every request is offered to the output check's sample."""
    latencies = []
    t0 = time.perf_counter()
    while True:
        g = next(groups)
        a, b = us[g[0]:g[0] + k], vs[g[0]:g[0] + k]
        ts = time.perf_counter()
        disp, cost = fn(a, b)
        te = time.perf_counter()
        latencies.append(te - ts)
        sample.offer((g, disp, cost))
        if te - t0 >= seconds:
            return latencies, te - t0


def check_outputs(root, cell: dict, us, vs, sample, device) -> tuple:
    """(numbers, failed requests): the sampled requests' maps against the
    reference's maps of their pairs, computed once a pair."""
    ref = spec.module(root, "reference", cell["config"]["reference"])
    idx = sorted({i for g, _, _ in sample for i in g})
    with torch.no_grad():
        r = ref.disparity(us[idx], vs[idx], cell["config"]["settings"],
                          device=device)
    at = {i: n for n, i in enumerate(idx)}
    per_req = []
    for g, disp, cost in sample:
        per_req.append(check.worst(
            check.compare_pair(disp[j], cost[j], r["disp"][at[i]],
                               r["cost"][at[i]]) for j, i in enumerate(g)))
    failed = sum(not check.verdict(n, cell["limits"])[0] for n in per_req)
    return check.worst(per_req), failed


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             *, device, started: float, serve=None) -> tuple[dict, list]:
    """(result, check lines) of one run.  `started` is the perf_counter
    reading of the process's start; `serve`, a callable (config, device)
    -> serve function, takes the program's place (the control and the
    fault tests)."""
    marks = [("process start -> harness", time.perf_counter())]
    cell = spec.cell(root, workload)
    config, traffic = cell["config"], cell["traffic"]
    make = serve or spec.module(root, "entries", traffic["entry"]).make
    fn = make(config, device)
    marks.append(("program import", time.perf_counter()))
    us, vs = make_pool(config, traffic, seed, device)
    marks.append(("pool", time.perf_counter()))
    k = traffic["pairs_per_request"]
    groups = request_groups(traffic, seed)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(traffic["warmup_requests"]):
        g = next(groups)
        fn(us[g[0]:g[0] + k], vs[g[0]:g[0] + k])
    _sync(device)
    marks.append((f"warm-up ({traffic['warmup_requests']} requests)",
                  time.perf_counter()))
    run = Run(config=config, traffic=traffic, kernels=cell["kernels"],
              setup_s=marks[-1][1] - started)
    print("set-up: " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (name, t), t_prev in
        zip(marks, [started] + [t for _, t in marks[:-1]])),
        file=sys.stderr)
    sample = _Sample(traffic["check_requests"], seed)
    run.latencies_s, run.window_s = _window(fn, groups, us, vs, k, seconds,
                                            sample)
    run.pairs = run.requests * k
    attempted = run.requests
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                traced_n = len(_window(fn, groups, us, vs, k, seconds,
                                       sample)[0])
        attempted += traced_n
        t = time.perf_counter()
        run.trace = trace.from_profiler(prof, traced_n)
        print(f"trace: {len(run.trace.device)} device and "
              f"{len(run.trace.host)} host operations in "
              f"{run.trace.window_s:.3f} s, read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        del prof
    if torch.device(device).type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    del fn
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, failed = check_outputs(root, cell, us, vs, sample.items, device)
    print(f"check: {len(sample.items)} of {attempted} requests against "
          f"the reference in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    correct, shown = check.verdict(numbers, cell["limits"])
    metrics = {}
    for m in cell["per_layer"] if traced else cell["end_to_end"]:
        read, data = spec.reader(root, m)
        value = read(run, **data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dict(memory_peak_bytes=run.peak_bytes))
    if traced:
        result["device"].update(busy_s=trace.busy_s(run.trace),
                                window_s=run.trace.window_s)
        result["breakdown"] = trace.breakdown(run.trace)
    result["check"] = shown
    lines = [f"check {n} {v['value']!r} limit {v['limit']!r}"
             for n, v in shown.items()]
    return result, lines
