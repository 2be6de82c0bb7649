"""The q quantile of the latencies of all the window's requests, in ms
(numpy's linear interpolation), a request timed from the call into the
entry with numpy inputs to its numpy outputs in hand."""
import numpy as np


def read(run, q: float):
    return float(np.quantile(np.asarray(run.latencies_s), q)) * 1e3
