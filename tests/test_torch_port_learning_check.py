"""The port's learning check (``dualvar_tpu_torch/tools/learning_check.py``)
on the CPU: the plumbing only. A pass needs its full configuration on the
card (``chip_smoke.py``'s learning phase).

* Its configurations are the JAX scripts' (``scripts/learning_check.py``
  ``main`` and ``classifier_check``, ``scripts/real_data_learning_check.py``
  ``main``): each script runs with its trainer replaced by a stub that keeps
  the configuration, and the fields both packages have must agree.
* Its frame tree is the JAX script's, file by file and byte by byte.
* Each of the four checks runs a few steps at a small size (float32 on the
  CPU): a record with the final value, the pass condition and the curve read
  back from the run's ``metrics.jsonl``.
"""

import dataclasses
import json
import math
import os
import tempfile

import pytest

from dualvar_tpu_torch.tools import learning_check as LC

import torch_port_util  # noqa: F401  (caps torch's threads)


def _common(jax_cfg, port_cfg, skip=()):
    """The fields of each config group both packages have, as dicts."""
    out = []
    for group in ("data", "model", "optim"):
        j = dataclasses.asdict(getattr(jax_cfg, group))
        p = dataclasses.asdict(getattr(port_cfg, group))
        keys = sorted(set(j) & set(p) - set(skip))
        out.append(({k: j[k] for k in keys}, {k: p[k] for k in keys}))
    return out


def _capture(monkeypatch, module, name, result):
    seen = {}

    def stub(cfg, max_steps=None, **kw):
        seen.update(cfg=cfg, max_steps=max_steps)
        return result

    monkeypatch.setattr(module, name, stub)
    return seen


def test_pretrain_configs_are_the_jax_scripts(monkeypatch, tmp_path):
    import scripts.learning_check as J

    for model in ("simclr_naked", "simclr_timeseriesv4"):
        seen = _capture(monkeypatch, J, "train", {"clip_loss": 0.0})
        J.main(LC.STEPS[model], model)
        assert seen["max_steps"] == LC.STEPS[model] == 300
        port = LC.pretrain_config(model, str(tmp_path))
        for j, p in _common(seen["cfg"], port):
            assert j == p
        assert port.run.print_freq == seen["cfg"].run.print_freq
    assert LC.MARGIN["simclr_naked"] == 0.4
    assert LC.chance_loss(16) == math.log(31)


def test_classifier_config_is_the_jax_scripts(monkeypatch, tmp_path):
    import dualvar_tpu.train.classifier as JC
    import scripts.learning_check as J

    seen = _capture(monkeypatch, JC, "train", {"val_top1": 1.0})
    J.classifier_check(LC.STEPS["classifier"])
    assert seen["max_steps"] == 360
    port = LC.classifier_config(str(tmp_path))
    for j, p in _common(seen["cfg"], port):
        assert j == p
    for key in ("print_freq", "eval_freq", "save_freq"):
        assert getattr(port.run, key) == getattr(seen["cfg"].run, key)
    assert port.num_class == seen["cfg"].num_class == 4
    assert LC.CLASSIFIER_TOP1 == 0.6


def test_real_files_config_and_tree_are_the_jax_scripts(monkeypatch,
                                                         tmp_path):
    import dualvar_tpu.train.pretrain as JP
    import scripts.real_data_learning_check as J

    # the script writes its tree under a new temp dir: this test's
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "jax"))
    os.makedirs(tmp_path / "jax")
    seen = _capture(monkeypatch, JP, "train", {"clip_loss": 0.0})
    assert J.main(LC.STEPS["real_files"], LC.BATCH) == 0
    jcfg = seen["cfg"]
    assert seen["max_steps"] == 60
    port = LC.real_files_config(jcfg.data.data_root, jcfg.data.db_path,
                                str(tmp_path))
    for j, p in _common(jcfg, port):
        assert j == p
    assert LC.MARGIN["real_files"] == 0.3
    # the tree: the JAX script's files, byte by byte
    root, db = str(tmp_path / "idx"), str(tmp_path / "frames")
    LC.write_tree(root, db)
    for name in ("ClassInd.txt", "train_split01.csv"):
        with open(os.path.join(root, name)) as a, \
                open(os.path.join(jcfg.data.data_root, name)) as b:
            got, want = a.read(), b.read()
        assert got.replace(db, "DB") == want.replace(jcfg.data.db_path, "DB")

    def files(top):
        return sorted(os.path.relpath(os.path.join(d, f), top)
                      for d, _, fs in os.walk(top) for f in fs)

    assert files(db) == files(jcfg.data.db_path)
    assert len(files(db)) == LC.REAL_VIDEOS * 5 * LC.SEQ
    for rel in files(db)[::97]:
        with open(os.path.join(db, rel), "rb") as a, \
                open(os.path.join(jcfg.data.db_path, rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("name,steps", [
    ("simclr_naked", 2), ("simclr_timeseriesv4", 2), ("classifier", 4),
    ("real_files", 2)])
def test_each_check_runs_at_a_small_size(name, steps, tmp_path):
    record = LC.run_check(name, steps=steps, device="cpu",
                          log_root=str(tmp_path), seq=4, img=32,
                          dtype="float32")
    assert record["check"] == name and record["steps"] == steps
    assert math.isfinite(record["final"])
    assert isinstance(record["passed"], bool)
    json.dumps(record)
    # 2 (4) steps: nothing at the 20-step marks, every logged step at 1
    assert record["curve"] == []
    if name == "classifier":
        assert 0.0 <= record["final"] <= 1.0
        assert record["condition"] == "val_top1 > 0.6"
    else:
        assert record["condition"] == (
            f"clip_loss < {math.log(31) - LC.MARGIN[name]}")
    # every logged step is in the run's metrics.jsonl, the last one too
    logged = []
    for d, _, fs in os.walk(str(tmp_path)):
        if "metrics.jsonl" in fs:
            logged = LC.read_curve(d, record["curve_tag"], every=1)
    assert logged and logged[-1][0] == steps, logged
