"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

The flow is the same for every cell; what differs lives in the cell's
driver (``drivers/<driver>.py``), chosen by its traffic file.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import torch

from portbench import registry
from portbench import trace as tracing

# top-level module names that may not be loaded in a run: JAX and the
# package the port was made from (compared whole: the port's own name,
# exploring_meta_tpu_torch, begins with the second)
FORBIDDEN = ("jax", "jaxlib", "flax", "exploring_meta_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


class Context:
    """What a per-layer metric's reader reads: the trace of the card alone
    over the profiled stretch, the window's host spans and counts, the
    cell's files and its driver."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, driver,
                 trace, profiled_units: int, window: dict):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.driver = driver
        self.trace = trace
        self.profiled_units = profiled_units
        self.window = window


def window(driver, seconds: float) -> dict:
    """Steps of the driver until ``seconds`` have passed: each step ends in
    a synchronize, so the window holds all the work it counts."""
    units, latencies = 0, []
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        t = time.perf_counter()
        n = driver.step()
        t1 = time.perf_counter()
        units += n
        latencies.append((t1 - t, n))
    return {"units": units, "seconds": t1 - t0, "latencies": latencies}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", variant: str = "program",
             overrides: dict | None = None) -> dict:
    """-> the result line of one run (and, under ``readings``, every number
    compared). ``variant`` ``control`` puts the reference in the lower
    precision in the program's place for the check (or names another
    precision to put there); ``overrides`` (tests at small sizes) update
    the configuration, traffic and limits."""
    overrides = overrides or {}
    bench = registry.benchmark()
    cell = registry.cell(name, bench)
    cfg = {**registry.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**registry.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    drv = registry.driver(traffic["driver"]).Driver(
        cfg, traffic, seed, torch.device(device))
    drv.phases["import"] = time.perf_counter() - t_start
    drv.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tr, host_tr, profiled_units = None, None, 0
    if trace:
        # the idle gaps by what the host did, from a stretch that records
        # the host too; every metric from one that records the card alone
        _, host_tr = tracing.profile(drv.profiled, host=True)
        profiled_units, tr = tracing.profile(drv.profiled)
    win = window(drv, seconds) if seconds > 0 else {
        "units": 0, "seconds": 0.0, "latencies": []}
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    ctx = Context(cell, cfg, traffic, drv, tr, profiled_units, win)
    metrics = {}
    if trace:
        for entry in registry.per_layer_for(name, bench):
            value = registry.metric(entry["name"]).read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        e2e = drv.end_to_end(win)
        for entry in registry.end_to_end_for(name, bench):
            value = setup_s if entry["name"] == "setup_s" else e2e.get(
                entry["name"])
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}

    drv.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    readings = drv.readings(variant)
    limits = {**registry.limits(name), **overrides.get("limits", {})}
    compared = {k: {"value": readings.get(k), "limit": lim}
                for k, lim in limits.items()}
    correct = bool(compared) and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in compared.values())

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win["units"],
           "failed": drv.failed, "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tracing.busy_s(tr.kernels)
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tracing.device_ops(tr.kernels),
                            "idle_gaps": tracing.idle_gaps(host_tr)}
    out["compared"] = compared
    out["readings"] = readings
    out["setup_phases"] = drv.phases
    return out


def print_result(result: dict) -> None:
    """The compared numbers, each beside its limit, as the last lines on
    standard error; then the result as the last line of standard output,
    with ``compared`` its last key."""
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_phases"].items()),
        file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {k: v for k, v in result.items()
            if k not in ("readings", "compared", "setup_phases")}
    line["compared"] = result["compared"]
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
