"""Helpers of the readers of the port's own spans and device marks (not a
metric: no entry of ``BENCHMARK.json`` names it).

The first reader's call traces a stretch of the cell with the port's
tracing on (``exploring_meta_tpu_torch.utils.profiling.tracing``) and no
``torch.profiler`` session, in a fresh process on the same device: the
cell's driver is built again from the run's configuration, traffic and
seed, one driver step inside a first trace captures the instrumented
twins of its graphs, and a second trace records the driver's
``profiled()`` stretch, its host wall timed around it (each step ends in a
synchronize). A fresh process, because a process that has run the
``--trace 1`` run's two profiler sessions serves its calls about twice as
slowly on the host afterwards, which would read into every host span and
the idle share. The child prints the stretch's readings as one JSON line;
they are kept on the context for the other readers. The run's own driver
is left as it was. Without a card, where the program has no ``tracing``
(a parent without the spans), or where the child fails, the readers
return None.

    python -m portbench.metrics._program_spans '<json: cfg, traffic, seed,
        device>'

runs the child by hand from the checkout's root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def stretch(ctx):
    """-> the traced stretch's readings (``calls``, ``units``,
    ``host_ms_per_call``, ``replay_device_ms``, ``span_idle_pct``,
    ``device_ms_per_replay``, ``dropped``, ...), run in a child process on
    the first call (on any device: the CPU's records host spans only);
    None where the program has no ``tracing`` or the child fails."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    try:
        from exploring_meta_tpu_torch.utils.profiling import tracing  # noqa
    except ImportError:
        return None
    drv = ctx.driver
    args = {"cfg": ctx.cfg, "traffic": ctx.traffic, "seed": drv.seed,
            "device": str(drv.device)}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.metrics._program_spans",
         json.dumps(args)], cwd=ROOT, capture_output=True, text=True,
        timeout=900, env={**os.environ, "PYTHONPATH": ROOT})
    if proc.returncode != 0:
        print(f"portbench: the traced stretch failed (exit "
              f"{proc.returncode}):\n{proc.stderr[-4000:]}", file=sys.stderr)
        return None
    ctx.program_spans = json.loads(proc.stdout.strip().splitlines()[-1])
    return ctx.program_spans


def traced(ctx):
    """The traced stretch of a cell on a card, else None."""
    drv = getattr(ctx, "driver", None)
    device = getattr(drv, "device", None)
    if device is None or device.type != "cuda":
        return None
    got = stretch(ctx)
    return got if got is not None and not got["dropped"] else None


def host_ms_per_call(ctx, name: str):
    """Host ms of the spans ``name`` over the stretch's calls (its root
    spans)."""
    got = traced(ctx)
    return None if got is None else got["host_ms_per_call"].get(name)


def replay_device_ms(ctx):
    """Mean device ms from a replay's first mark to its last."""
    got = traced(ctx)
    return None if got is None else got["replay_device_ms"]


def span_idle_pct(ctx):
    """100 x (1 - the union of the replays' device intervals / the
    stretch's host wall)."""
    got = traced(ctx)
    return None if got is None else got["span_idle_pct"]


def device_ms_per_replay(ctx, name: str):
    """Device ms inside the marks of span ``name`` a replay."""
    got = traced(ctx)
    return None if got is None else got["device_ms_per_replay"].get(name)


# ---------------------------------------------------------------------------
# the child
# ---------------------------------------------------------------------------

def busy_ns(intervals, lo: int, hi: int) -> int:
    """ns of ``[lo, hi]`` that the union of ``(start, end)`` covers."""
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
        end = max(end, e)
    return busy


def readings(trace, start: int, end: int, units: int) -> dict:
    """What the readers read of a stretch's ``Trace`` (host spans and
    device intervals on one clock) and its host wall ``[start, end]``."""
    roots = [s for s in trace.spans if s.parent is None]
    calls = len(roots)
    host: dict = {}
    for s in trace.spans:
        host[s.name] = host.get(s.name, 0) + s.end_ns - s.start_ns
    reps = [(iv.start_ns, iv.end_ns)
            for iv in trace.device_intervals("graphs.replay")]
    summary = trace.summary()
    out = {"units": units, "calls": calls, "wall_ms": 1e-6 * (end - start),
           "host_ms_per_call": ({k: 1e-6 * v / calls
                                 for k, v in host.items()} if calls else {}),
           "replay_device_ms": None, "span_idle_pct": None,
           "device_ms_per_replay": {},
           "dropped": summary["dropped_stamps"],
           "clock_offsets_us": summary["clock_offsets_us"],
           "clock_drift_us": summary["clock_drift_us"],
           "idle_by_span": trace.idle_by_span()}
    if reps:
        out["replay_device_ms"] = 1e-6 * sum(e - s for s, e in reps) / len(
            reps)
        out["span_idle_pct"] = 100.0 * (
            1.0 - busy_ns(reps, start, end) / (end - start))
        for iv in trace.intervals:
            if iv.name != "graphs.replay":
                per = out["device_ms_per_replay"]
                per[iv.name] = per.get(iv.name, 0.0) + 1e-6 * (
                    iv.end_ns - iv.start_ns) / len(reps)
    return out


def main(argv) -> int:
    import torch

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import registry
    from exploring_meta_tpu_torch.utils.profiling import tracing

    args = json.loads(argv[0])
    device = torch.device(args["device"])
    drv = registry.driver(args["traffic"]["driver"]).Driver(
        args["cfg"], args["traffic"], args["seed"], device)
    drv.setup()
    with tracing(device):
        drv.step()
    with tracing(device) as trace:
        start = time.perf_counter_ns()
        units = drv.profiled()
        end = time.perf_counter_ns()
    print(json.dumps(readings(trace, start, end, units)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
