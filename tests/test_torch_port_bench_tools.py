"""Each bench tool of the port end to end on the CPU (``--smoke --device
cpu``, the JAX scripts' smoke shapes, into ``tmp_path``): its records carry
the JAX records' keys (read from the scripts with ``ast``), their rates
agree with their step times as rounded, they land where ``--out`` says, and
the ``BENCH_*.json`` records at the repo root stay byte for byte as they
were.
"""

import ast
import glob
import json
import math
import os

import pytest

from dualvar_tpu_torch.tools import backbone_bench as BB
from dualvar_tpu_torch.tools import bench as BN
from dualvar_tpu_torch.tools import eval_bench as EB
from dualvar_tpu_torch.tools import objective_bench as OB
from dualvar_tpu_torch.tools import perf_breakdown as PB
from dualvar_tpu_torch.tools import step_breakdown as SB

import torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--smoke", "--device", "cpu", "--steps", "2", "--chains", "2"]
# the JAX headline record's sensitivity band (bench.py: a100_band)
BAND = [f"vs_baseline_at_{u}pct_a100_util" for u in (35, 45, 55)]


@pytest.fixture(scope="module", autouse=True)
def root_records():
    """The repo root's ``BENCH_*.json``, unchanged by every test here."""
    paths = sorted(glob.glob(os.path.join(ROOT, "BENCH_*.json")))
    before = {p: open(p, "rb").read() for p in paths}
    assert before, "the JAX package's records are at the root"
    yield
    assert sorted(glob.glob(os.path.join(ROOT, "BENCH_*.json"))) == paths
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


def _dict_keys(script, function, var):
    """The constant keys of the dict literals assigned to ``var`` in
    ``function`` of ``script`` (in order of appearance)."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    return [[k.value for k in node.value.keys if k is not None]
            for node in ast.walk(fn) if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) == var
            and isinstance(node.value, ast.Dict)]


def _run(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr().out.splitlines()
    assert code == 0
    return json.loads(out[-1])


def _rates_agree(rec, clips_per_step):
    """``clips_per_sec`` against ``clips_per_step`` / ``ms_per_step``: the
    step time is rounded to 0.1 ms and the rate to 0.1."""
    ms = rec["ms_per_step"]
    want = clips_per_step / (ms / 1e3)
    slack = clips_per_step * 1e3 * 0.05 / (ms - 0.05) ** 2 + 0.05
    assert abs(rec["clips_per_sec"] - want) <= slack, (rec, want)


def test_bench_record(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rec = _run(BN.main, SMOKE + ["--out", str(out)], capsys)
    (headline,) = [k for k in _dict_keys("bench.py", "main", "record")
                   if "batch_size" in k]
    assert set(headline) | set(BAND) <= set(rec)
    assert rec["batch_size"] == 2 and rec["backend"] == "cpu"
    assert rec["value"] == pytest.approx(4 / (rec["ms_per_step"] / 1e3),
                                         rel=0.01)
    _rates_agree(rec, 4)
    assert rec["step_tflops"] is not None and rec["mfu_pct"] is None
    assert rec["vs_baseline"] == pytest.approx(
        rec["vs_baseline_at_45pct_a100_util"])
    # rounded to 3 digits, as the JAX record: the CPU's tiny ratios may tie
    assert rec["vs_baseline_at_35pct_a100_util"] >= rec["vs_baseline"] >= \
        rec["vs_baseline_at_55pct_a100_util"]
    assert json.load(open(out)) == rec


def test_bench_input_pipeline_record(tmp_path, capsys, monkeypatch):
    """The step fed from a JPEG tree written from a seed."""
    monkeypatch.setattr(BN, "JPEG_ROOT", str(tmp_path / "bench_jpegs"))
    out = tmp_path / "pipeline.json"
    rec = _run(BN.main, SMOKE + ["--input-pipeline", "--out", str(out)],
               capsys)
    (pipeline,) = [k for k in _dict_keys("bench.py", "main", "record")
                   if "resident_batch_clips_per_sec" in k]
    assert set(pipeline) <= set(rec)
    assert rec["value"] > 0 and rec["steps"] == BN.PIPELINE_STEPS
    assert rec["host_cores"] >= 1 and rec["h2d_MBps"] > 0
    assert math.isfinite(rec["final_loss"])
    videos = glob.glob(str(tmp_path / "bench_jpegs" / "*" / "*"))
    assert len(videos) == 4 * 2 + 16
    assert json.load(open(out)) == rec


def test_objective_bench_records(tmp_path, capsys):
    out = tmp_path / "objectives.json"
    recs = _run(OB.main, SMOKE + ["moco_naked_r3d", "simclr_tsv4_r21d",
                                  "--out", str(out)], capsys)
    (keys,) = _dict_keys("scripts/objective_bench.py", "bench_unit", "rec")
    for rec, views in zip(recs, (2, 3)):
        assert set(keys) <= set(rec)
        assert rec["n_views"] == views and rec["batch"] == 2
        _rates_agree(rec, 2 * views)
        assert math.isfinite(rec["final_loss"])
    assert recs[0]["moco_k"] == 8 and recs[1]["moco_k"] is None
    doc = json.load(open(out))
    assert [r["name"] for r in doc["results"]] == ["simclr_tsv4_r21d",
                                                   "moco_naked_r3d"]


@pytest.mark.parametrize("module,script,clips_per_step", [
    (BB, "scripts/backbone_bench.py", 4), (EB, "scripts/eval_bench.py", 2)])
def test_backbone_and_eval_bench_records(module, script, clips_per_step,
                                         tmp_path, capsys):
    out = tmp_path / "out.json"
    (rec,) = _run(module.main, SMOKE + ["r3d", "--out", str(out)], capsys)
    (keys,) = _dict_keys(script, "bench_net", "rec")
    assert set(keys) <= set(rec)
    assert rec["net"] == "r3d" and rec["batch"] == 2
    _rates_agree(rec, clips_per_step)
    assert json.load(open(out))["results"] == [rec]


@pytest.mark.parametrize("module,labels", [
    (SB, list(SB.SEGMENTS)),
    (PB, ["aug", "aug_fwd", "step", "step_b256"])])
def test_breakdown_records(module, labels, tmp_path, capsys):
    out = tmp_path / "breakdown.json"
    recs = _run(module.main, SMOKE + ["--out", str(out)], capsys)
    assert [r["segment"] for r in recs] == labels
    for rec in recs:
        _rates_agree(rec, 4)
        value = rec["loss" if rec["segment"].startswith("step")
                    else "output"]
        assert math.isfinite(value)
        assert ("step_tflops" in rec) == (rec["segment"] != "aug")
    assert json.load(open(out))["results"] == recs


def test_a_breakdown_segment_can_be_chosen(tmp_path, capsys):
    recs = _run(SB.main, SMOKE + ["fwdloss", "--out",
                                  str(tmp_path / "x.json")], capsys)
    assert [r["segment"] for r in recs] == ["fwdloss"]
    with pytest.raises(SystemExit):
        SB.main(SMOKE + ["nope"])
