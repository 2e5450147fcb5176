"""The soaks (``dualvar_tpu_torch/tools/soak.py``, ``tools/moco_soak.py``)
on the CPU at their smallest sizes, with the time loop cut short: the MoCo
rehearsal (``--smoke``) against the JAX package's ring update, the checks
failing where the state is wrong, the SimCLR soak's replays against its
live steps, and both tools' flags and record keys against the JAX scripts'
(read with ``ast``; ``--device`` is the port's own flag, as everywhere).
"""

import ast
import contextlib
import io
import json
import math
import os

import jax.numpy as jnp
import pytest
import torch

from dualvar_tpu.models.ssl.moco import dequeue_and_enqueue
from dualvar_tpu_torch.tools import moco_soak as MS
from dualvar_tpu_torch.tools import soak as S

import torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a loop this short runs one chain, the save and its live steps
SHORT_MINUTES = 0.001
SMALL = dict(minutes=SHORT_MINUTES, batch=2, chain=2, device="cpu", seq=4,
             img=32, frame_hw=(40, 36), dtype="float32")


def _main(main, argv):
    """(exit code, the record of the last line, the details line's
    object) of a tool's ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    lines = out.getvalue().splitlines()
    details = next(json.loads(line.split(": ", 1)[1]) for line in lines
                   if line.startswith("[moco-soak] details: "))
    return code, json.loads(lines[-1]), details


def _smoke(tmp_path, monkeypatch):
    monkeypatch.setattr(MS, "SMOKE_MINUTES", SHORT_MINUTES)
    monkeypatch.setenv("SOAK_CKPT_DIR", str(tmp_path / "ckpt"))
    return _main(MS.main, ["--smoke", "--device", "cpu"])


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return _smoke(tmp_path_factory.mktemp("moco_soak"), mp)


def test_moco_smoke_wraps_and_its_pointer_is_the_jax_ring(smoke):
    code, record, details = smoke
    assert code == 0
    K, B = MS.SMOKE_MODEL["moco_k"], MS.SMOKE_BATCH
    assert record["batch_size"] == B and record["backend"] == "cpu"
    assert record["queue_wraps"] >= 1
    # the JAX package's ring update, applied once a step to a zero queue
    queue, ptr = jnp.zeros((K, 8)), jnp.int32(0)
    for _ in range(record["steps"]):
        queue, ptr = dequeue_and_enqueue(queue, ptr, jnp.ones((B, 8)))
    assert record["ptr_actual"] == record["ptr_expected"] == int(ptr)
    assert record["ptr_ok"] and record["ema_finite"]
    # float32 keys, l2-normalised: a few float32 ulps off 1
    assert record["queue_norm_max_dev"] <= 1e-5
    assert math.isfinite(record["first_loss"])
    assert math.isfinite(record["last_loss"])


def test_moco_smoke_replays_are_bitwise_each_other_and_the_live_steps(smoke):
    _, record, details = smoke
    live, replays = details["live"], details["replays"]
    assert len(live) == S.REPLAY_STEPS and len(replays) == S.REPLAYS
    assert all(r == live for r in replays)
    # each step moves the pointer by B
    assert [p for _, p in live] == [
        (details["saved_at_step"] + i + 1) * MS.SMOKE_BATCH
        % MS.SMOKE_MODEL["moco_k"] for i in range(S.REPLAY_STEPS)]
    assert record["resume_deterministic"] is True


def test_a_pointer_off_by_one_fails_the_soak(tmp_path, monkeypatch):
    checks = MS.queue_checks

    def bumped(model, *args):
        model.queue_ptr.add_(1)
        return checks(model, *args)

    monkeypatch.setattr(MS, "queue_checks", bumped)
    code, record, _ = _smoke(tmp_path, monkeypatch)
    assert record["ptr_ok"] is False
    assert record["ptr_actual"] == record["ptr_expected"] + 1
    assert code == 1


def test_soak_replays_are_the_live_steps():
    record, details = S.run_soak(**SMALL)
    assert set(record) >= {"value", "steps", "resume_deterministic"}
    assert record["chains"] >= 1 and record["batch_size"] == 2
    assert record["steps"] == 1 + 2 * record["chains"] + S.REPLAY_STEPS
    assert all(math.isfinite(x) for x in details["live"])
    assert math.isfinite(record["first_loss"])
    assert math.isfinite(record["last_loss"])
    assert details["replays_agree"] and details["replays_match_live"]
    assert details["replays"] == [details["live"]] * S.REPLAYS
    assert record["resume_deterministic"] is True


def test_a_checkpoint_with_another_generator_state_breaks_the_resume(
        monkeypatch):
    """The replays draw their augmentation from the saved generator state;
    another state gives other draws: the replays still agree with each
    other, not with the live steps."""
    saved = S.training_state

    def other_generator(*args, **kw):
        state = saved(*args, **kw)
        state["generator"] = torch.Generator().manual_seed(12345).get_state()
        return state

    monkeypatch.setattr(S, "training_state", other_generator)
    record, details = S.run_soak(**SMALL)
    assert details["replays_agree"] is True
    assert details["replays_match_live"] is False
    assert record["resume_deterministic"] is False


def _parsed(path):
    with open(os.path.join(ROOT, path)) as fh:
        return ast.parse(fh.read())


def _flags(tree):
    return {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)}


def _record_keys(tree):
    """The keys of the dict literal assigned to ``record``."""
    found = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict)
             and [getattr(t, "id", None) for t in n.targets] == ["record"]]
    assert len(found) == 1
    return [k.value for k in found[0].keys]


@pytest.mark.parametrize("jax_script,port_tool", [
    ("scripts/soak.py", "dualvar_tpu_torch/tools/soak.py"),
    ("scripts/moco_soak.py", "dualvar_tpu_torch/tools/moco_soak.py")])
def test_flags_and_record_keys_are_the_jax_scripts(jax_script, port_tool):
    jax_tree, port_tree = _parsed(jax_script), _parsed(port_tool)
    assert _flags(port_tree) - _flags(jax_tree) == {"--device"}
    assert _flags(jax_tree) - _flags(port_tree) == set()
    assert _record_keys(port_tree) == _record_keys(jax_tree)
