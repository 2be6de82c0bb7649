"""Profiling helpers (mirror of mgm_tpu/utils/profiling.py: device
traces and wall timers)."""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block (CPU, and CUDA when
    a card is present) and write it under `logdir` in the format
    TensorBoard's profiler plugin reads."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _sync(x) -> None:
    """Wait for the card when x (a tensor, or a list, tuple or dict of
    them) holds a CUDA tensor."""
    if isinstance(x, dict):
        x = list(x.values())
    items = x if isinstance(x, (list, tuple)) else [x]
    for a in items:
        if isinstance(a, (list, tuple, dict)):
            _sync(a)
        elif isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)


@contextlib.contextmanager
def timed(tag: str, sync=None):
    """Wall-clock a block; pass `sync` (a tensor or a container of
    tensors) to wait for the card before reading the clock."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        _sync(sync)
    print(f"[{tag}] {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
