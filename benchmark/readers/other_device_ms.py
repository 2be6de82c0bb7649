"""Device time a request of every operation outside kernels.json's
`exclude` groups (the hand kernels and the copies), in ms, over the
traced window."""
from benchmark.trace import device_s


def read(run, exclude):
    if run.trace is None or not run.trace.device:
        return None
    return (device_s(run.trace, None, run.prefixes(exclude))
            / run.trace.requests * 1e3)
