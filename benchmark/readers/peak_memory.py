"""torch.cuda.max_memory_allocated() over the set-up and the window, in
GiB: whether a scene fits on the card."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
