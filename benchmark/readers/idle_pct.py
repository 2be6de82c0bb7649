"""100 x (1 - busy share) of the traced window: the share of the window
in which no operation ran on the device."""
from benchmark.trace import busy_s


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - busy_s(run.trace) / run.trace.window_s)
