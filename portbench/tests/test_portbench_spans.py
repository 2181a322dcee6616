"""The readers of the port's own spans (``metrics/_program_spans.py`` and
the metrics that use it): None without a card, without spans, or on a
program without ``tracing``; on the CPU the traced stretch (a child
process) leaves the run's driver, its host times, kept answers and
failures as it found them; the child's readings by hand."""

import types

import pytest
import torch

from conftest import SMALL

from portbench import harness, registry
from portbench.metrics import _program_spans

NEW = ("serve_copy_in_ms", "serve_launch_ms", "serve_clone_out_ms",
       "replay_device_ms", "span_idle_pct", "double_backward_ms")


def _readers(cell: str) -> list:
    bench = registry.benchmark()
    return [m["name"] for m in registry.per_layer_for(cell, bench)
            if m["name"].split(".")[0] in NEW]


def _context(cell: str, steps: int = 3):
    entry = registry.cell(cell, registry.benchmark())
    cfg = {**registry.config(entry["config"]),
           **SMALL[cell].get("config", {})}
    traffic = {**registry.traffic(entry["traffic"]),
               **SMALL[cell]["traffic"], "profile_steps": 2}
    drv = registry.driver(traffic["driver"]).Driver(
        cfg, traffic, 2 ** 31 + 9, torch.device("cpu"))
    drv.setup()
    win = harness.window(drv, 0.0)
    for _ in range(steps):
        drv.step()
    return harness.Context(entry, cfg, traffic, drv, None, 0, win)


def test_every_cell_reads_new_metrics():
    assert len(_readers("omniglot-5w5s-serve-b64")) == 5
    assert len(_readers("particles2d-vpg-serve-b64")) == 5
    assert len(_readers("omniglot-5w5s-train-fused")) == 3


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_stretch_on_the_cpu_leaves_the_driver_as_it_was(cell):
    ctx = _context(cell)
    drv = ctx.driver
    host = list(drv.host_s)
    kept = list(getattr(drv, "kept", []))
    got = _program_spans.stretch(ctx)
    assert got["units"] > 0 and got["wall_ms"] > 0
    assert got["calls"] == 2        # profile_steps calls or chunks
    assert got["replay_device_ms"] is None and got["dropped"] == 0
    assert drv.host_s == host and getattr(drv, "kept", []) == kept
    assert drv.failed == 0
    assert _program_spans.stretch(ctx) is got
    # no card: no reading, though the CPU recorded host spans
    assert _program_spans.traced(ctx) is None
    for name in _readers(cell):
        assert registry.metric(name).read(ctx) is None


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_readers_without_spans_or_tracing(cell, monkeypatch):
    from exploring_meta_tpu_torch.utils import profiling
    card = types.SimpleNamespace(device=torch.device("cuda"))
    empty = harness.Context({}, {}, {}, card, None, 0, {})
    empty.program_spans = _program_spans.readings(profiling.Trace(), 0, 1,
                                                  1)
    for name in _readers(cell):
        assert registry.metric(name).read(empty) is None
    nothing = harness.Context({}, {}, {}, None, None, 0, {})
    for name in _readers(cell):
        assert registry.metric(name).read(nothing) is None
    # a program without tracing (the parent of the spans): None, no run
    monkeypatch.delattr(profiling, "tracing")
    old = harness.Context({}, {}, {}, card, None, 0, {})
    assert _program_spans.stretch(old) is None
    for name in _readers(cell):
        assert registry.metric(name).read(old) is None


def test_readings_of_a_stretch_by_hand():
    from exploring_meta_tpu_torch.utils.profiling import SpanRecord, Trace
    ms = 1_000_000
    spans = [SpanRecord(1, "serve.batch", 0, 4 * ms, None, 1, 0, {}),
             SpanRecord(2, "graphs.copy_in", 1 * ms, 2 * ms, 1, 1, 0, {}),
             SpanRecord(3, "serve.batch", 5 * ms, 9 * ms, None, 3, 0, {}),
             SpanRecord(4, "graphs.copy_in", 6 * ms, 8 * ms, 3, 3, 0, {})]
    stamps = [(2, 2 * ms), (3, 5 * ms), (4, 3 * ms), (5, 4 * ms),
              (5 * 2, 3 * ms), (5 * 2 + 1, 4 * ms),
              (2, 7 * ms), (3, 9 * ms)]
    trace = Trace(spans, stamps, sites={1: "graphs.replay",
                                        2: "cnn4_block_double_backward",
                                        5: "cnn4_block_double_backward"})
    got = _program_spans.readings(trace, 0, 10 * ms, 128)
    assert got["calls"] == 2 and got["units"] == 128
    assert got["host_ms_per_call"] == {"serve.batch": 4.0,
                                       "graphs.copy_in": 1.5}
    assert got["replay_device_ms"] == pytest.approx(2.5)
    # replays cover [2, 5] and [7, 9] ms of a 10 ms wall
    assert got["span_idle_pct"] == pytest.approx(50.0)
    assert got["device_ms_per_replay"] == {
        "cnn4_block_double_backward": pytest.approx(1.0)}
    assert _program_spans.busy_ns([(0, 5), (3, 8), (12, 20)], 2, 15) == 9
