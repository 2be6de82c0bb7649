"""Reduction of one torch.profiler window to what the per-layer readers
read: the device's operations (kernels, copies, memsets) with their
times, the host's operations, the busy share and the idle gaps.

The busy time is the union of the device operations' intervals, as
chip_profile.py's `_device_profile` computes it.  Which operations are
which kernel, or a copy, kernels.json says by name prefix.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# the host's annotation of the traced window
WINDOW = "benchmark.window"
# the longest name the breakdown keeps
NAME_CHARS = 160


@dataclass
class Trace:
    """Times in seconds from the start of the traced window."""
    window_s: float
    requests: int
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)


def _clean(name: str) -> str:
    """A kernel's name without the return type the demangler prints."""
    return name[5:] if name.startswith("void ") else name


def _short(name: str) -> str:
    """A name cut to NAME_CHARS for the breakdown (PyTorch's kernels
    carry pages of template arguments)."""
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + "..."


def from_profiler(prof, requests: int) -> Trace:
    """The Trace of a finished torch.profiler.profile whose window the
    host annotated as WINDOW (torch.profiler.record_function).  The
    annotation's own events (on the host, and its copy on the device's
    timeline) are not operations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = [e for e in events
           if e.name() == WINDOW and e.device_type() != cuda]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW} spans "
                           f"on the host")
    t0 = win[0].start_ns()
    tr = Trace(window_s=win[0].duration_ns() / 1e9, requests=requests)
    for e in events:
        if e.name() == WINDOW or e.is_user_annotation():
            continue
        s = (e.start_ns() - t0) / 1e9
        iv = (s, s + e.duration_ns() / 1e9, _clean(e.name()))
        (tr.device if e.device_type() == cuda else tr.host).append(iv)
    tr.device.sort()
    tr.host.sort()
    return tr


def matches(name: str, prefixes) -> bool:
    return any(name.startswith(p) for p in prefixes)


def device_s(tr: Trace, prefixes=None, exclude=()) -> float:
    """Seconds of device time of the operations whose names start with
    one of `prefixes` (all when None) and with none of `exclude`."""
    return sum(e - s for s, e, n in tr.device
               if (prefixes is None or matches(n, prefixes))
               and not matches(n, exclude))


def busy_s(tr: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in tr.device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(tr: Trace) -> list:
    """The idle intervals (start, end) of the device inside the
    window."""
    out, edge = [], 0.0
    for s, e, _ in tr.device:
        if s > edge:
            out.append((edge, s))
        edge = max(edge, e)
    if tr.window_s > edge:
        out.append((edge, tr.window_s))
    return out


def _host_at(host: list, times: list) -> list:
    """The innermost host operation running at each of the ascending
    `times` (a host thread's operations nest, so a stack of the open
    ones holds it on top)."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host (no traced operation)")
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps
    summed by what the host was doing in the middle of each, `top` of
    each, [[name, seconds], ...]."""
    ops = {}
    for s, e, n in tr.device:
        ops[_short(n)] = ops.get(_short(n), 0.0) + (e - s)
    idle = {}
    spans = gaps(tr)
    for (s, e), what in zip(spans, _host_at(tr.host,
                                            [(s + e) / 2 for s, e in spans])):
        idle[_short(what)] = idle.get(_short(what), 0.0) + (e - s)

    def head(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": head(ops), "idle_gaps": head(idle)}
