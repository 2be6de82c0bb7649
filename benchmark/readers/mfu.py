"""The whole request's share of the card's float32 peak, in %: the
solve's operations (work.solve_work) of every pair completed in the
untraced window over the window's seconds times F32_OPS.  It bounds the
solve's roofline share from below while any kernel of it is on the
path, and reads the window that throughput_mpds reads, not the
profiler's."""
from benchmark.work import F32_OPS, solve_work


def read(run):
    if not run.pairs:
        return None
    return 100.0 * solve_work(run.config)[0] * run.pairs / (
        run.window_s * F32_OPS)
