"""Finds every piece of a cell by its name.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. The configuration is
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json``
(its ``driver`` key names ``drivers/<driver>.py``), each per-layer
metric ``metrics/<metric>.py`` and the cell's limits for ``correct``
``limits/<cell>.json``. Nothing here lists the cells, mixes or metrics
that exist: adding one adds files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json("limits", f"{cell_name}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``; a
    name may hold dots, so the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_for(cell_name: str, bench: dict) -> list:
    """The end-to-end metrics a cell reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_for(cell_name: str, bench: dict) -> list:
    e2e = {m["name"] for m in end_to_end_for(cell_name, bench)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in e2e]
