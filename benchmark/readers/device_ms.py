"""Device time a request of the operations whose names start with a
prefix of kernels.json's `kernels` groups, in ms, over the traced
window; nothing when none ran."""
from benchmark.trace import device_s


def read(run, kernels):
    if run.trace is None:
        return None
    t = device_s(run.trace, run.prefixes(kernels))
    return t / run.trace.requests * 1e3 if t > 0 else None
