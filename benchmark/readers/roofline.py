"""The solve layer's share of its roofline, in %: the least time its
work needs at the published peaks (work.solve_bound_s, counted from
the cell's shapes) over the device time of the `kernels` groups, a
request.  Nothing when none of them ran."""
from benchmark.trace import device_s
from benchmark.work import solve_bound_s


def read(run, kernels):
    if run.trace is None:
        return None
    t = device_s(run.trace, run.prefixes(kernels)) / run.trace.requests
    if t <= 0:
        return None
    bound, _ = solve_bound_s(run.config, run.traffic["pairs_per_request"])
    return 100.0 * bound / t
