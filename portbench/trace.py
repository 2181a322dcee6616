"""Reads ``torch.profiler`` records into what the per-layer metrics need:
device kernels by name with their times, the device's busy time, and the
idle gaps between kernels labelled by what the host was doing.

Kernels launched by a CUDA-graph replay are recorded by name like any
other; host ranges (``record_function``) inside a captured graph are not.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    start: float     # seconds
    end: float


class Trace(NamedTuple):
    kernels: list    # device kernels, Spans sorted by start
    host: list       # host operations and runtime calls, Spans
    window_s: float  # the trace's span: first device record to last


def profile(fn, host: bool = False):
    """``fn()`` under ``torch.profiler``, ended by a synchronize -> (fn's
    result, :class:`Trace`). Only the card's activity is recorded unless
    ``host``: recording the host's operations slows its launches, so a
    trace with them reads the device idler than an untraced run is."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    prof = prof_ctx(activities=activities)
    torch.cuda.synchronize()
    prof.start()
    out = fn()
    torch.cuda.synchronize()
    prof.stop()
    kernels, hosts, device = [], [], []
    for evt in prof.events():
        rng = evt.time_range
        span = Span(evt.name, rng.start * 1e-6, rng.end * 1e-6)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
            if _is_kernel(evt.name):
                kernels.append(span)
        else:
            hosts.append(span)
    kernels.sort(key=lambda s: s.start)
    window = (max(s.end for s in device) - min(s.start for s in device)
              if device else 0.0)
    return out, Trace(kernels, hosts, window)


def _is_kernel(name: str) -> bool:
    """Device records that are not kernels: copies and sets."""
    return not name.startswith(("Memcpy", "Memset"))


def short_name(name: str) -> str:
    """A kernel's name without its namespace, argument list or template
    arguments: ``(anonymous namespace)::bwd_dw_tc_kernel<...>(...)`` ->
    ``bwd_dw_tc_kernel``; a library kernel keeps its first 60 letters."""
    base = re.sub(r"\(anonymous namespace\)::", "", name)
    base = base.split("(")[0]
    base = re.sub(r"<.*", "", base).strip()
    base = base.split("::")[-1] if "::" in base else base
    base = base.replace("void ", "").strip()
    return (base or name)[:60]


def busy_intervals(kernels: list) -> list:
    """The union of the kernels' intervals, as sorted ``(start, end)``."""
    out: list = []
    for s in kernels:
        if out and s.start <= out[-1][1]:
            if s.end > out[-1][1]:
                out[-1][1] = s.end
        else:
            out.append([s.start, s.end])
    return [tuple(x) for x in out]


def busy_s(kernels: list) -> float:
    return sum(e - s for s, e in busy_intervals(kernels))


def device_ops(kernels: list, top: int = 10) -> list:
    """``[[name, seconds]]`` of the kernels that took most device time, by
    short name."""
    total: dict = {}
    for s in kernels:
        key = short_name(s.name)
        total[key] = total.get(key, 0.0) + (s.end - s.start)
    return [[k, v] for k, v in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]


def kernel_seconds(kernels: list, names) -> float:
    """Device seconds of the kernels whose short name is in ``names``."""
    names = set(names)
    return sum(s.end - s.start for s in kernels
               if short_name(s.name) in names)


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """``[[what the host did, seconds]]``: the device's idle time between
    its first and last kernel, summed by the host record that was running
    at each gap's midpoint (the innermost one), longest first."""
    spans = busy_intervals(trace.kernels)
    host = sorted(trace.host, key=lambda s: s.start)
    total: dict = {}
    active: list = []
    nxt = 0
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        mid = 0.5 * (e0 + s1)           # increasing from gap to gap
        while nxt < len(host) and host[nxt].start <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h.end >= mid]
        inner = min(active, key=lambda h: h.end - h.start, default=None)
        key = inner.name[:60] if inner is not None else "host: no record"
        total[key] = total.get(key, 0.0) + gap
    return [[k, v] for k, v in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]
