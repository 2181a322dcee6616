"""Per-phase timing and device traces, ``--profile`` / ``--trace`` (port of
``exploring_meta_tpu/utils/profiling.py``).

``PhaseTimer`` keeps JAX's phases and its ``phase_times.json`` schema,
``{name: {"total_s", "mean_ms", "count"}}``. A phase's clock stops after
a barrier on the device of the tensors it produced, so it times the work
and not its dispatch. ``device_trace`` records the host and the card with
``torch.profiler`` and writes a Chrome trace. ``graph_ms_per_call``
times a call's kernels back to back in a CUDA graph: the device time
that ``chip_smoke.py`` and ``cuda/compare_cnn4.py`` report.

``span`` and ``tracing`` are the port's own spans. ``span(name, device=,
ranged=, **attrs)`` marks a stretch of the program: off (the default) it
does nothing but, if ``ranged``, open a ``record_function`` range of its
name while a ``torch.profiler`` session is active. Inside ``with tracing() as trace:`` each
span keeps its host times, its parent and the call it belongs to, and a
span given ``device=`` the card enqueues a device mark at its begin and
end (``csrc/marks.cu``), which a CUDA-graph capture keeps as nodes of the
graph, so each replay stamps them again. ``trace`` reads them once the
block ends: :meth:`Trace.summary`, :meth:`Trace.idle_by_span`.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch


def _devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def host_sync(tree) -> None:
    """Return only after all device work queued before the call, on every
    card that holds a tensor of ``tree``, has run. A CPU tensor's work is
    done when its op returns."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def no_phase(name: str):
    """The phase of a run without ``--profile``: a no-op whose yielded list
    takes what a timed phase would sync on."""
    return contextlib.nullcontext([])


class PhaseTimer:
    """Wall-clock per named phase, each ended by a barrier on the device
    work it produced."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time a block. Tensors made INSIDE the block are registered by
        appending them to the yielded list; ``block_on`` takes ones that
        exist already. Both are synced before the clock stops."""
        outputs: list = []
        t0 = time.perf_counter()
        try:
            yield outputs
        finally:
            if block_on is not None:
                host_sync(block_on)
            if outputs:
                host_sync(outputs)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": round(total, 4),
                       "mean_ms": round(1e3 * total
                                        / max(self.counts[name], 1), 3),
                       "count": self.counts[name]}
                for name, total in self.totals.items()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, sort_keys=True, indent=4)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record the block with ``torch.profiler`` (the host, and the card
    when there is one) and write ``trace_<pid>_<ns>.json``, a Chrome trace,
    into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def graph_ms_per_call(fn, calls: int = 20, replays: int = 10) -> float:
    """ms of one call of ``fn`` run back to back on the current CUDA
    device: ``calls`` calls captured in one CUDA graph, its replays timed
    by CUDA events. A call of a few microseconds launched from Python one
    at a time is timed by the host's dispatch; a replay launches the same
    kernels with no host between them, so this is their device time and
    the gaps between kernels on the device. (The profiler's per-kernel
    records are not used: after many sessions in one process CUPTI has
    been seen to deliver a session's records into the next one.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------------------
# the port's spans and device marks
# ---------------------------------------------------------------------------

# stamps the device buffer of a card holds (16 bytes each); a stamp past it
# is dropped and counted
MARK_CAPACITY = 1 << 20

_profiler_on = torch._C._autograd._profiler_enabled
_active = None                 # the Trace being recorded, or None
_span_ids = itertools.count(1)
_site_ids = itertools.count(1)
SITES: dict = {}               # site id -> span name, over the process
_marks_lib = None
_buffers: dict = {}            # card -> (stamps, counters, calibration x2)


class SpanRecord(NamedTuple):
    """A closed host span: ids, ``time.perf_counter_ns`` times, the id of
    its parent (None for a root), the call id its root gave, the thread it
    ran on and its attributes."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    call: int
    thread: int
    attrs: dict


class DeviceInterval(NamedTuple):
    """A begin and an end mark of one site, on the host spans' clock."""
    site: int
    name: str
    start_ns: int
    end_ns: int


class _Off:
    """A span while tracing is off, outside a profiler's range."""
    site = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


_OFF = _Off()


class _Ranged(_Off):
    """A span while tracing is off: a ``record_function`` range."""

    def __init__(self, name: str):
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        return self.rf.__exit__(*exc)


class _Span:
    __slots__ = ("trace", "name", "device", "attrs", "site", "rf",
                 "capturing", "id", "call", "parent", "start")

    def __init__(self, trace, name, device, attrs):
        self.trace, self.name, self.device = trace, name, device
        self.attrs = attrs

    def note(self, **attrs):
        """Adds attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        tr = self.trace
        self.rf = None
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.capturing = (tr.card is not None
                          and torch.cuda.is_current_stream_capturing())
        if not self.capturing:
            stack = tr._stack()
            up = stack[-1] if stack else None
            self.id = next(_span_ids)
            self.parent = None if up is None else up.id
            self.call = self.id if up is None else up.call
            stack.append(self)
            self.start = time.perf_counter_ns()
        self.site = None
        if self.device is not None and tr._marks_on(self.device):
            self.site = next(_site_ids)
            SITES[self.site] = self.name
            tr._mark(self.site, 0)
        return self

    def __exit__(self, *exc):
        tr = self.trace
        if self.site is not None:
            tr._mark(self.site, 1)
        if not self.capturing:
            end = time.perf_counter_ns()
            tr._stack().pop()
            tr.spans.append(SpanRecord(self.id, self.name, self.start, end,
                                       self.parent, self.call,
                                       threading.get_ident(), self.attrs))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, device=None, ranged: bool = False, **attrs):
    """A context manager over a stretch of the program named ``name``.

    Off (outside :func:`tracing`) it records and launches nothing; a
    ``ranged`` span (one of the profiler ranges the port opened before it
    had spans) checks whether a ``torch.profiler`` session records and, if
    so, opens a ``record_function`` range of ``name``. The others open none
    while tracing is off, so that a profile of an untraced program holds
    the ranges it held before them (a range costs about 8 host µs under a
    card-only profile). Inside :func:`tracing` the span opens its range
    whenever a profiler records, and keeps its host start and end
    (``time.perf_counter_ns``), parent, call id (that of the outermost span
    open on its thread) and ``attrs``, unless the current stream is being
    captured: a capture runs nothing, so it records no host span. With
    ``device`` (a ``torch.device`` on the traced card) it also enqueues a
    device mark at its begin and end on the current stream, captured or
    not, under a site id of its own (``.site`` of the entered span)."""
    trace = _active
    if trace is None:
        return _Ranged(name) if ranged and _profiler_on() else _OFF
    return _Span(trace, name, device, attrs)


def tracing_on() -> bool:
    return _active is not None


def _lib():
    global _marks_lib
    if _marks_lib is None:
        from exploring_meta_tpu_torch.cuda import build
        lib = build.load("marks.cu")
        P, U = ctypes.c_void_p, ctypes.c_ulonglong
        lib.span_mark.argtypes = [P, P, U, U, P]
        lib.span_mark.restype = ctypes.c_int
        _marks_lib = lib
    return _marks_lib


def _launch_mark(card, stamps, counters, capacity: int, tag: int) -> None:
    with torch.cuda.device(card):
        err = _lib().span_mark(stamps.data_ptr(), counters.data_ptr(),
                               capacity, tag,
                               torch.cuda.current_stream(card).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span_mark launch failed: cudaError {err}")


def _card_buffers(card):
    """The card's stamp buffer and counters (and a one-stamp pair for the
    clock's calibration), made at its first trace and kept for the
    process: captured marks hold their addresses."""
    if card not in _buffers:
        _lib()
        made = [torch.zeros(MARK_CAPACITY, 2, dtype=torch.int64,
                            device=card),
                torch.zeros(2, dtype=torch.int64, device=card),
                torch.zeros(1, 2, dtype=torch.int64, device=card),
                torch.zeros(2, dtype=torch.int64, device=card)]
        torch.cuda.synchronize(card)
        _buffers[card] = made
    return _buffers[card]


class Trace:
    """What one :func:`tracing` block recorded: ``spans`` (closed host
    spans, :class:`SpanRecord`), ``intervals`` (each site's begin and end
    marks paired in order, on the host clock, :class:`DeviceInterval`),
    ``offsets_ns`` (host ns minus device ns of a mark launched at the
    block's entry and of one at its exit: the two clocks run at rates a
    few parts in a million apart, so a mark is placed by the offset
    interpolated between the two at its device time), and ``dropped``
    (stamps past the buffer's capacity). Made by hand from spans and
    ``stamps`` (``(site * 2 + end, device ns)``) for tests, the entry's
    offset then placing every mark."""

    def __init__(self, spans=(), stamps=(), sites=None, offsets_ns=(0, 0),
                 dropped: int = 0, card=None):
        self.card = card
        self.spans: list = list(spans)
        self.sites = dict(SITES if sites is None else sites)
        self.offsets_ns = tuple(offsets_ns)
        self.calibration = None     # device ns of the entry and exit marks
        self.dropped = dropped
        self.intervals = self._pair(stamps)
        self._local = threading.local()

    # -- recording --------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _marks_on(self, device) -> bool:
        if self.card is None:
            return False
        device = torch.device(device)
        if device.type != "cuda":
            return False
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return index == self.card.index

    def _mark(self, site: int, end: int) -> None:
        stamps, counters = _card_buffers(self.card)[:2]
        _launch_mark(self.card, stamps, counters, MARK_CAPACITY,
                     2 * site + end)

    def _calibrate(self) -> tuple:
        """-> (host ns minus device ns, device ns) of one mark: synchronize,
        launch it, take the host's time as the launch returns; the median
        of three, after a first launch that loads the kernel."""
        stamp, counters = _card_buffers(self.card)[2:]
        got = []
        for _ in range(4):
            counters.zero_()
            torch.cuda.synchronize(self.card)
            _launch_mark(self.card, stamp, counters, 1, 0)
            host = time.perf_counter_ns()
            torch.cuda.synchronize(self.card)
            device = int(stamp[0, 1])
            got.append((host - device, device))
        return sorted(got[1:])[1]

    def _open(self) -> None:
        if self.card is None:
            return
        _card_buffers(self.card)[1].zero_()
        self._entry = self._calibrate()
        self.offsets_ns = (self._entry[0], self._entry[0])

    def _close(self) -> None:
        if self.card is None:
            return
        torch.cuda.synchronize(self.card)
        stamps, counters = _card_buffers(self.card)[:2]
        head, dropped = (int(v) for v in counters.cpu())
        raw = stamps[:min(head, MARK_CAPACITY)].cpu().tolist()
        exit_ = self._calibrate()
        self.offsets_ns = (self._entry[0], exit_[0])
        self.calibration = (self._entry[1], exit_[1])
        self.dropped = dropped
        self.sites = dict(SITES)
        self.intervals = self._pair(raw)

    def _pair(self, stamps) -> list:
        """Each site's begin and end stamps paired innermost first (a stack
        a site), on the host clock."""
        off, d0, rate = self.offsets_ns[0], 0, 0.0
        if self.calibration is not None:
            d0, d1 = self.calibration
            if d1 > d0:
                rate = (self.offsets_ns[1] - off) / (d1 - d0)

        def place(ns: int) -> int:
            return ns + off + round(rate * (ns - d0))

        open_: dict = defaultdict(list)
        out = []
        for tag, ns in stamps:
            site, end = divmod(int(tag), 2)
            if not end:
                open_[site].append(ns)
            elif open_[site]:
                begin = open_[site].pop()
                out.append(DeviceInterval(site, self.sites.get(site, "?"),
                                          place(begin), place(ns)))
        out.sort(key=lambda iv: iv.start_ns)
        return out

    # -- reading ----------------------------------------------------------

    @property
    def drift_ns(self) -> int:
        """How far the exit's clock offset lies from the entry's."""
        return self.offsets_ns[1] - self.offsets_ns[0]

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def device_intervals(self, name: str | None = None) -> list:
        return [iv for iv in self.intervals
                if name is None or iv.name == name]

    def linked(self, name: str) -> list:
        """``[(host span, DeviceInterval or None)]`` of the host spans
        ``name`` that carry a ``site`` attribute: the k-th such span of a
        site takes the site's k-th interval (launch order; a graph's site
        is fixed at its capture and stamped by each replay)."""
        by_site: dict = defaultdict(list)
        for iv in self.intervals:
            by_site[iv.site].append(iv)
        taken: dict = defaultdict(int)
        out = []
        for s in sorted(self.named(name), key=lambda s: s.start_ns):
            site = s.attrs.get("site")
            ivs = by_site.get(site, [])
            k = taken[site]
            taken[site] += 1
            out.append((s, ivs[k] if k < len(ivs) else None))
        return out

    def summary(self) -> dict:
        """``{"spans": {name: {count, host_ms_total, host_ms_mean
        [, device_count, device_ms_total, device_ms_mean]}},
        "dropped_stamps", "clock_offsets_us", "clock_drift_us"}``: host
        figures from the host spans, device ones from the name's marks."""
        out: dict = {}
        for s in self.spans:
            row = out.setdefault(s.name, {"count": 0, "host_ms_total": 0.0})
            row["count"] += 1
            row["host_ms_total"] += 1e-6 * (s.end_ns - s.start_ns)
        for iv in self.intervals:
            row = out.setdefault(iv.name, {"count": 0, "host_ms_total": 0.0})
            row["device_count"] = row.get("device_count", 0) + 1
            row["device_ms_total"] = (row.get("device_ms_total", 0.0)
                                      + 1e-6 * (iv.end_ns - iv.start_ns))
        for row in out.values():
            if row["count"]:
                row["host_ms_mean"] = row["host_ms_total"] / row["count"]
            if row.get("device_count"):
                row["device_ms_mean"] = (row["device_ms_total"]
                                         / row["device_count"])
        return {"spans": out, "dropped_stamps": self.dropped,
                "clock_offsets_us": [1e-3 * o for o in self.offsets_ns],
                "clock_drift_us": 1e-3 * self.drift_ns}

    def idle_by_span(self, top: int = 10) -> list:
        """``[[span name, ms]]``: the device's idle time between its marked
        intervals (their union), summed by the innermost host span running
        at each gap's midpoint (``"no span"`` where none is), longest
        first."""
        busy = busy_union([(iv.start_ns, iv.end_ns) for iv in self.intervals])
        host = sorted(self.spans, key=lambda s: s.start_ns)
        total: dict = {}
        active: list = []
        nxt = 0
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            while nxt < len(host) and host[nxt].start_ns <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h.end_ns >= mid]
            inner = min(active, key=lambda h: h.end_ns - h.start_ns,
                        default=None)
            key = inner.name if inner is not None else "no span"
            total[key] = total.get(key, 0.0) + 1e-6 * (s1 - e0)
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]


def busy_union(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted ``[start, end]``
    pairs that do not touch."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _card(device):
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


@contextlib.contextmanager
def tracing(device=None):
    """Turns the port's spans on for the block and yields the
    :class:`Trace` they fill, complete once the block ends. On a card
    (``device``, by default the current CUDA device when there is one) the
    first trace of the process builds and loads ``csrc/marks.cu`` and
    makes the card's stamp buffer; each trace zeroes it, takes the clock's
    offset at entry and exit (each a synchronize and one mark), and copies
    the stamps to the host once, at exit. Graphs captured inside the block
    are the instrumented twins of those captured outside it
    (``utils/graphs.py``). Traces do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing() is already on")
    trace = Trace(card=_card(device))
    trace._open()
    _active = trace
    try:
        yield trace
    finally:
        _active = None
        trace._close()
