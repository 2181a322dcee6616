"""Per-phase timing and device traces, ``--profile`` / ``--trace`` (port of
``exploring_meta_tpu/utils/profiling.py``).

``PhaseTimer`` keeps JAX's phases and its ``phase_times.json`` schema,
``{name: {"total_s", "mean_ms", "count"}}``. A phase's clock stops after
a barrier on the device of the tensors it produced, so it times the work
and not its dispatch. ``device_trace`` records the host and the card with
``torch.profiler`` and writes a Chrome trace. ``graph_ms_per_call``
times a call's kernels back to back in a CUDA graph: the device time
that ``chip_smoke.py`` and ``cuda/compare_cnn4.py`` report.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

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
