"""Everything ``BENCHMARK.json`` names is found by name, and a file added
beside the others is found without an edit."""

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(w):
    cell = spec.cell(w)
    assert cell.config["name"] == next(
        x["config"]
        for x in BENCH["workloads"] if x["name"] == w)
    assert cell.traffic["batch_per_process"] > 0
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    for trace_on in (False, True):
        for m in spec.metrics(w, trace_on):
            assert callable(spec.reader(m["name"]).read)


def test_every_metric_has_a_reader_and_reports_somewhere():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert os.path.exists(os.path.join(spec.HERE, "metrics",
                                               m["name"] + ".py")), m
            cells = [w["name"] for w in BENCH["workloads"]]
            assert any(m in spec.metrics(c, kind == "per_layer")
                       for c in cells), m


def test_names_and_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_a_new_mix_is_found_by_name(tmp_path, monkeypatch):
    """A later change adds a traffic file and a cell: nothing else."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "k400_simclr_r21d.b16",
                               "config": "k400_simclr_r21d",
                               "traffic": "b16", "chips": 1, "why": "x"})
    traffic = tmp_path / "b16.json"
    traffic.write_text(json.dumps({"batch_per_process": 16, "processes": 1,
                                   "pool_batches": 4, "compared_steps": 3,
                                   "sync_every": 20, "trace_steps": 3}))
    limits = tmp_path / "k400_simclr_r21d.b16.json"
    limits.write_text(json.dumps({"loss": {"limit": 1.0}}))
    real_json = spec._json

    def fake_json(path):
        base = os.path.basename(path)
        if base == "b16.json":
            return real_json(str(traffic))
        if base == "k400_simclr_r21d.b16.json":
            return real_json(str(limits))
        return real_json(path)

    monkeypatch.setattr(spec, "benchmark", lambda: bench)
    monkeypatch.setattr(spec, "_json", fake_json)
    cell = spec.cell("k400_simclr_r21d.b16")
    assert cell.traffic["batch_per_process"] == 16
    assert [m["name"] for m in spec.metrics(cell.name, False)] == [
        m["name"] for m in BENCH["end_to_end"]]
