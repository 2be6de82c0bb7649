"""MP*disp of every request completed in the window over the window's
seconds: all the work over all the time (work.pair_mpdisp)."""
from benchmark.work import pair_mpdisp


def read(run):
    return run.pairs * pair_mpdisp(run.config) / run.window_s
