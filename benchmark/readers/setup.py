"""Seconds from the process's start to the first timed request: the
imports, the CUDA context, the kernel library (built on a checkout's
first run), the pool and the warm-up requests."""


def read(run):
    return run.setup_s
