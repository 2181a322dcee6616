"""The result line's schema, the compared numbers printed last, and the
reduction of a profiler trace to busy time, top kernels and idle gaps."""

import json

import pytest

from conftest import SMALL

from portbench import harness
from portbench import trace as tracing
from portbench.trace import Span


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_last_line_schema(cell, capsys):
    out = harness.run_cell(cell, 2 ** 31 + 11, 0.3, False, 0.0,
                           device="cpu", overrides=SMALL[cell])
    harness.print_result(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert "setup_s" in line["metrics"]
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    err = captured.err.strip().splitlines()
    assert all(x.startswith("compared ")
               for x in err[-len(line["compared"]):])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_same_seed_same_inputs(cell):
    """Two set-ups from one seed make the same weights and inputs."""
    import torch
    from portbench import registry
    made = []
    for _ in range(2):
        entry = registry.cell(cell, registry.benchmark())
        cfg = {**registry.config(entry["config"]), **SMALL[cell].get(
            "config", {})}
        traffic = {**registry.traffic(entry["traffic"]),
                   **SMALL[cell]["traffic"]}
        drv = registry.driver(traffic["driver"]).Driver(
            cfg, traffic, 2 ** 31 + 5, torch.device("cpu"))
        drv.setup()
        made.append({k: v for k, v in vars(drv).items()
                     if k in ("sx", "qx", "sy", "pool", "cls", "smp",
                              "images", "params0", "params")})
    flat = [[t for v in m.values() for t in _tensors(v)] for m in made]
    assert flat[0] and len(flat[0]) == len(flat[1])
    assert all(torch.equal(a, b) for a, b in zip(*flat))


def _tensors(tree):
    import torch
    if torch.is_tensor(tree):
        return [tree.detach()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _trace():
    kernels = [Span("void (anonymous namespace)::fwd_conv_stats_kernel<"
                    "float, 4>(float const*)", 0.0, 1.0),
               Span("bwd_dw_kernel(float*)", 0.5, 2.0),
               Span("sm80_xmma_gemm_f32f32", 3.0, 4.0),
               Span("sm80_xmma_gemm_f32f32", 6.0, 6.5)]
    host = [Span("cudaGraphLaunch", 1.9, 3.5),
            Span("aten::copy_", 4.0, 7.0),
            Span("cudaMemcpyAsync", 4.5, 5.5)]
    return tracing.Trace(kernels, host, 10.0)


def test_busy_time_is_the_union_of_kernels():
    tr = _trace()
    assert tracing.busy_s(tr.kernels) == pytest.approx(2.0 + 1.0 + 0.5)


def test_idle_is_one_traces_share_of_its_span():
    """Idle is 1 - busy / span, both from the one trace: never below 0."""
    from portbench.metrics import _shared
    ctx = harness.Context({}, {}, {}, None, _trace(), 1, {})
    assert _shared.idle_pct(ctx) == pytest.approx(100.0 * (1 - 3.5 / 10.0))
    empty = tracing.Trace([], [], 0.0)
    assert _shared.idle_pct(harness.Context({}, {}, {}, None, empty, 1,
                                            {})) is None


def test_top_kernels_by_short_name():
    ops = dict(tracing.device_ops(_trace().kernels))
    assert ops == {"fwd_conv_stats_kernel": 1.0, "bwd_dw_kernel": 1.5,
                   "sm80_xmma_gemm_f32f32": 1.5}


def test_idle_gaps_by_the_innermost_host_record():
    gaps = dict(tracing.idle_gaps(_trace()))
    # gap 2.0-3.0 (mid 2.5): the graph launch; gap 4.0-6.0 (mid 5.0): the
    # memcpy inside the copy
    assert gaps == {"cudaGraphLaunch": 1.0, "cudaMemcpyAsync": 2.0}


def test_p95_is_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0
