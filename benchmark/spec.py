"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``), its
limits of the correctness check (``limits/<cell>.json``) and each metric's
reader (``metrics/<name>.py``). A later change adds a configuration, a mix
or a metric by adding its file and its entry, and edits none of these."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@functools.lru_cache(maxsize=None)
def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its name
    traffic: dict  # the traffic mix's file, with its name
    limits: dict  # number compared -> {"limit": ..., ...}


def cell(name: str) -> Cell:
    bench = benchmark()
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    config = {**_json(os.path.join(ROOT, c["file"])), "name": c["name"]}
    traffic = {**_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
               "name": w["traffic"]}
    limits = _json(os.path.join(HERE, "limits", f"{name}.json"))
    return Cell(name, int(w["chips"]), config, traffic, limits)


def metrics(cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones without
    the trace, the per-layer ones with it; an entry with ``workloads``
    only in the cells it lists."""
    entries = benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


@functools.lru_cache(maxsize=None)
def reader(metric: str):
    """The module ``metrics/<metric>.py``: ``read(ctx)`` returns the
    metric's value, or None where the run gives it nothing to read;
    ``HOOKS`` (optional) names the module groups it needs timed in the
    trace (group -> class names)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
