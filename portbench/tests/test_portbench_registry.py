"""``BENCHMARK.json`` against the benchmark's contract, every name
resolved to its file, and a configuration, traffic mix, metric and cell
added as files and entries only."""

import json
import os
import re
import shutil

import torch

from conftest import ROOT, SMALL

from portbench import harness, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(w.startswith("portbench/") or "/" not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_cells_resolve_to_files():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        registry.config(w["config"])
        traffic = registry.traffic(w["traffic"])
        assert hasattr(registry.driver(traffic["driver"]), "Driver")
        assert registry.limits(w["name"])


def test_metrics_entries_and_readers_agree():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers: dict = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        reader = registry.metric(m["name"])
        assert (reader.UNIT, reader.SOURCE, reader.LAYER, reader.MOVES) == (
            m["unit"], m["source"], m["layer"], m["moves"])
        mover = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in mover.get("workloads", [cell])
    for w in BENCH["workloads"]:
        got = registry.end_to_end_for(w["name"], BENCH)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert registry.per_layer_for(w["name"], BENCH)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert all(m["unit"] == "%" for m in BENCH["per_layer"]
               if "_roofline" in m["name"] or "mfu" in m["name"])


def test_a_cell_added_as_files_only(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a per-layer metric, limits and a
    cell added as new files and entries run with no code edited."""
    copy = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), copy,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    base = "particles2d-vpg-serve-b64"
    cfg = registry.config("particles2d-mlp100-f32")
    cfg["name"] = "particles2d-mlp64-f32"
    cfg["hiddens"] = [64, 64]
    (copy / "configs" / "particles2d-mlp64-f32.json").write_text(
        json.dumps(cfg))
    traffic = {**registry.traffic("rl-vpg-serve-b64"), "batch": 2}
    (copy / "traffic" / "rl-vpg-serve-b2.json").write_text(
        json.dumps(traffic))
    (copy / "limits" / "new-cell.json").write_text(
        '{"step_gap_all": 0.002}')
    (copy / "metrics" / "calls_per_window.new.py").write_text(
        'UNIT, SOURCE, LAYER = "count", "host_clock", "harness"\n'
        'MOVES = "rl_serve_requests_per_s"\n\n\n'
        'def read(ctx):\n    return len(ctx.window["latencies"])\n')
    bench["workloads"].append({"name": "new-cell",
                               "config": "particles2d-mlp64-f32",
                               "traffic": "rl-vpg-serve-b2", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if base in m.get("workloads", []):
            m["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", str(copy))
    monkeypatch.setattr(registry, "ROOT", str(tmp_path))
    small = SMALL[base]
    out = harness.run_cell("new-cell", 5, 0.3, False, 0.0, device="cpu",
                           overrides={"traffic": small["traffic"]})
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "rl_serve_requests_per_s",
                                   "rl_serve_p95_ms"}
    reader = registry.metric("calls_per_window.new")
    ctx = harness.Context({}, {}, {}, None, None, 0,
                          {"latencies": [(0.1, 2)] * 3})
    assert reader.read(ctx) == 3
    assert torch.is_tensor(torch.zeros(1))
