"""The port's benches (``dualvar_tpu_torch/tools/{timing,sweep_merge,bench,
objective_bench,backbone_bench,eval_bench,step_breakdown}.py``) against the
JAX package's scripts, on the CPU: the units' and nets' tables (read from
the scripts with ``ast``, so no JAX script runs), the records' merge, the
eval step, the parameters the breakdown holds, the operation counter against
an analytic count, and the batch search's one fallback.
"""

import ast
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvar_tpu.aug.pipeline import AugConfig as JaxAugConfig
from dualvar_tpu.aug.pipeline import eval_batch as jax_eval_batch
from dualvar_tpu.core import config as jax_config
from dualvar_tpu.models.backbones import select_backbone as jax_backbone
from dualvar_tpu.models.heads import LinearClassifier as JaxClassifier
from dualvar_tpu.models.ssl.simclr import SimCLRNaked as JaxSimCLRNaked
from dualvar_tpu_torch.aug.pipeline import AugConfig
from dualvar_tpu_torch.core.convert import _convert_leaf, from_jax_variables
from dualvar_tpu_torch.models.backbones import select_backbone
from dualvar_tpu_torch.models.backbones.r3d import R3DNet
from dualvar_tpu_torch.models.heads import LinearClassifier
from dualvar_tpu_torch.models.ssl.simclr import SimCLRNaked
from dualvar_tpu_torch.tools import backbone_bench as BB
from dualvar_tpu_torch.tools import bench as BN
from dualvar_tpu_torch.tools import eval_bench as EB
from dualvar_tpu_torch.tools import objective_bench as OB
from dualvar_tpu_torch.tools import step_breakdown as SB
from dualvar_tpu_torch.tools import sweep_merge as SM
from dualvar_tpu_torch.tools import timing

import torch_port_util  # noqa: F401  (caps torch's threads)
from torch_port_util import numpy_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
# the eval step's band: a backbone forward against its JAX counterpart
EVAL_ATOL = 2e-4


def _module(path):
    with open(os.path.join(ROOT, path)) as fh:
        return ast.parse(fh.read())


def _assigned(tree, name):
    """The value node assigned to ``name`` at the module's top level."""
    for node in tree.body:
        target = getattr(node, "target", None) or (
            node.targets[0] if isinstance(node, ast.Assign) else None)
        if isinstance(target, ast.Name) and target.id == name:
            return node.value
    raise KeyError(name)


def _jax_units():
    """The JAX script's ``UNITS``, its expression evaluated with the JAX
    package's configuration module (which imports no JAX)."""
    node = _assigned(_module("scripts/objective_bench.py"), "UNITS")
    return eval(compile(ast.Expression(node), "objective_bench", "eval"),
                {"PRETRAIN_PRESETS": jax_config.PRETRAIN_PRESETS,
                 "ModelConfig": jax_config.ModelConfig,
                 "dataclasses": dataclasses})


@pytest.mark.parametrize("name", list(OB.UNITS))
def test_objective_unit_is_the_jax_unit(name):
    """Names and order, every field of the port's ``ModelConfig`` and the
    batch candidates; the smoke variant as the JAX script's ``--smoke``."""
    jax_units = _jax_units()
    assert list(OB.UNITS) == list(jax_units)
    (cfg, batches), (jcfg, jbatches) = OB.UNITS[name], jax_units[name]
    assert batches == jbatches
    fields = [f.name for f in dataclasses.fields(cfg)]
    assert {f: getattr(cfg, f) for f in fields} == \
        {f: getattr(jcfg, f) for f in fields}
    scfg, sbatches = OB.units(smoke=True)[name]
    assert sbatches == (2,)
    assert (scfg.moco_k, scfg.dtype) == (8, "float32")
    assert dataclasses.replace(scfg, moco_k=cfg.moco_k, dtype=cfg.dtype) == cfg


@pytest.mark.parametrize("script,module", [
    ("scripts/backbone_bench.py", BB), ("scripts/eval_bench.py", EB)])
def test_candidates_are_the_jax_scripts(script, module):
    node = _assigned(_module(script), "CANDIDATES")
    assert module.CANDIDATES == ast.literal_eval(node)
    assert list(module.CANDIDATES) == list(ast.literal_eval(node))


def _shape_assigns(script):
    """The values of the script's ``T, H0, W0, IMG = ...`` assignments."""
    return [ast.literal_eval(n.value) for n in ast.walk(_module(script))
            if isinstance(n, ast.Assign)
            and isinstance(n.targets[0], ast.Tuple)
            and [getattr(e, "id", None) for e in n.targets[0].elts]
            == ["T", "H0", "W0", "IMG"]]


def test_shapes_are_the_jax_scripts():
    """16x112x112 from 171x128 frames; ``--smoke`` at T=4, 40x36, 32x32."""
    smoke, full = _shape_assigns("scripts/objective_bench.py")
    assert BN.SHAPES == full and BN.SMOKE_SHAPES == smoke
    assert _shape_assigns("scripts/backbone_bench.py") == [full]
    assert _shape_assigns("scripts/eval_bench.py") == [full]


# --------------------------------------------------------------------------
# the merge
# --------------------------------------------------------------------------

def _jax_merge():
    sys.path.insert(0, SCRIPTS)
    try:
        import _sweep_merge
    finally:
        sys.path.remove(SCRIPTS)
    return _sweep_merge


def _untimed(doc):
    """The document without its wall-clock stamps."""
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items()
                if k not in ("measured_at", "ts")}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


MERGE_SEQUENCE = (
    {"net": "s3d", "batch": 64, "ms_per_step": 91.9, "clips_per_sec": 1393.0},
    {"net": "r3d", "batch": 128, "ms_per_step": 300.0,
     "clips_per_sec": 853.3},
    {"net": "s3d", "batch": 256, "error": "OutOfMemoryError"},
    {"net": "s3d", "batch": 64, "ms_per_step": 95.0, "clips_per_sec": 1347.4},
    {"net": "s3d", "batch": 256, "ms_per_step": 400.0,
     "clips_per_sec": 1280.0},
    {"net": "s3d", "batch": 128, "ms_per_step": 160.0,
     "clips_per_sec": 1600.0},
    {"net": "c3d", "error": "all batch candidates failed"},
    {"net": "c3d", "batch": 32, "ms_per_step": 70.0, "clips_per_sec": 914.3},
)


def test_merge_is_the_jax_merge(tmp_path, capsys):
    """One sequence (a row, another net, an out-of-memory error, the same
    batch again, a slower other batch, a faster one, an error replaced by
    a success) through both merges: the same document after each record,
    stamps aside."""
    jax_merge = _jax_merge()
    fresh = {"shape": "16x112^2", "device": "x", "results": []}
    order = list(BB.CANDIDATES)
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    for rec in MERGE_SEQUENCE:
        SM.merge_result(ours, dict(rec), json.loads(json.dumps(fresh)),
                        order)
        jax_merge.merge_result(theirs, dict(rec),
                               json.loads(json.dumps(fresh)), order)
        with open(ours) as a, open(theirs) as b:
            doc = _untimed(json.load(a))
            assert doc == _untimed(json.load(b))
        if "error" in rec and rec["net"] == "s3d":
            (s3d,) = [r for r in doc["results"] if r["net"] == "s3d"]
            assert s3d["last_error"]["batch"] == 256
    doc = json.load(open(ours))
    (s3d,) = [r for r in doc["results"] if r["net"] == "s3d"]
    # the same-batch re-measurement replaced the row and its last_error
    assert s3d["batch"] == 128 and "last_error" not in s3d
    assert {a["batch"] for a in s3d["also_measured"]} == {64, 256}
    assert [r["net"] for r in doc["results"]] == ["r3d", "c3d", "s3d"]


@pytest.mark.parametrize("spec", ["256", "256,128", " 64 , 32", "x", "0",
                                  "", "4,-2"])
def test_parse_batches_is_the_jax_parser(spec):
    jax_merge = _jax_merge()
    try:
        want = jax_merge.parse_batches(spec)
    except SystemExit as exc:
        with pytest.raises(SystemExit) as ours:
            SM.parse_batches(spec)
        assert str(ours.value) == str(exc)
    else:
        assert SM.parse_batches(spec) == want


# --------------------------------------------------------------------------
# the eval step
# --------------------------------------------------------------------------

def _jax_eval_step(model, aug_cfg):
    """``scripts/eval_bench.py``'s ``eval_step`` (the function defined in
    its ``bench_net``), its source compiled here with its free names."""
    fn = next(n for n in ast.walk(_module("scripts/eval_bench.py"))
              if isinstance(n, ast.FunctionDef) and n.name == "eval_step")
    namespace = {"jax": jax, "jnp": jnp, "eval_batch": jax_eval_batch,
                 "model": model, "aug_cfg": aug_cfg}
    exec(compile(ast.Module([fn], []), "eval_bench", "exec"), namespace)
    return namespace["eval_step"]


def test_eval_step_matches_jax():
    """r3d, 4x32x32 crops from 40x36 frames, B=2, float32, the same
    weights: the port's eval step against the JAX script's, probabilities
    within the backbone band."""
    T, H0, W0, S, B = 4, 40, 36, 32, 2
    backbone, info = jax_backbone("r3d")
    jmodel = JaxClassifier(backbone=backbone,
                           feature_size=info["feature_size"],
                           num_class=EB.NUM_CLASS)
    params, stats = numpy_variables(jmodel, jnp.zeros((B, T, S, S, 3)),
                                    seed=5, train=False)
    frames = np.random.default_rng(0).integers(0, 255, (B, T, H0, W0, 3),
                                               dtype=np.uint8)
    want = np.asarray(_jax_eval_step(
        jmodel, JaxAugConfig(img_dim=S, seq_len=T))(params, stats,
                                                    jnp.asarray(frames)))
    tb, tinfo = select_backbone("r3d")
    model = LinearClassifier(tb, tinfo["feature_size"],
                             num_class=EB.NUM_CLASS)
    model.load_state_dict(from_jax_variables(params, stats, model))
    model.eval()
    got = EB.make_eval_step(model, AugConfig(img_dim=S, seq_len=T),
                            torch.float32)(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (B, EB.NUM_CLASS)
    np.testing.assert_allclose(got.numpy(), want, atol=EVAL_ATOL, rtol=0)
    # the comparison has teeth: the probabilities are far from uniform
    assert want.max() - want.min() > 100 * EVAL_ATOL


# --------------------------------------------------------------------------
# the breakdown's held parameters
# --------------------------------------------------------------------------

def _jax_frozen(freeze_conv1, freeze_bn):
    """``scripts/step_breakdown.py``'s ``is_frozen`` over the JAX
    ``SimCLRNaked`` r3d tree, each path mapped to the port's name."""
    from flax.traverse_util import flatten_dict

    model = JaxSimCLRNaked(network="r3d", dim=128, temperature=0.07)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 4, 32, 32, 3)),
        train=True))
    names = set()
    for path, leaf in flatten_dict(shapes["params"]).items():
        joined = "/".join(path)
        if ((freeze_conv1 and joined.startswith("backbone/conv1"))
                or (freeze_bn and ("/bn/" in joined
                                   or joined.endswith("/bn")))):
            names.add(_convert_leaf(path, np.zeros(leaf.shape))[0])
    return names


@pytest.mark.parametrize("freeze_conv1,freeze_bn,count",
                         [(True, False, 1), (False, True, 24)])
def test_held_parameters_are_the_jax_scripts(freeze_conv1, freeze_bn, count):
    model = SimCLRNaked(network="r3d", dim=128, temperature=0.07)
    held = SB.frozen_names(model, freeze_conv1, freeze_bn)
    assert len(held) == count
    assert set(held) == _jax_frozen(freeze_conv1, freeze_bn)


def test_a_held_parameter_takes_no_update():
    """``step_fz1``: the stem's weight gets no gradient and stays bitwise
    after its steps; every other parameter moves."""
    seg = SB.Segment("step_fz1", 2, True, torch.device("cpu"))
    params = dict(seg.trainer.model.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    seg.step()
    assert seg.held == ["backbone.conv1.weight"]
    assert params["backbone.conv1.weight"].grad is None
    assert torch.equal(params["backbone.conv1.weight"],
                       before["backbone.conv1.weight"])
    assert not torch.equal(params["backbone.layer1_block0.conv1.weight"],
                           before["backbone.layer1_block0.conv1.weight"])


# --------------------------------------------------------------------------
# the operation counter
# --------------------------------------------------------------------------

def _analytic_flops(model, x):
    """2 x output elements x in-channels / groups x kernel volume, summed
    over every Conv3d and Linear the call runs."""
    total = []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Conv3d):
            per = module.in_channels // module.groups * int(
                np.prod(module.kernel_size))
        else:
            per = module.in_features
        total.append(2 * output.numel() * per)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv3d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return sum(total)


def test_step_flops_is_the_analytic_count():
    """The R3D-18 forward at (1, 3, 8, 32, 32): ``step_flops`` equals the
    analytic sum exactly (1,623,457,792). XLA:CPU's ``cost_analysis`` of
    the JAX package's ``R3DNet`` at (1, 8, 32, 32, 3) gives 1,278,072,320,
    0.787 of it: XLA counts another number (not asserted)."""
    torch.manual_seed(0)
    model = R3DNet().eval()
    x = torch.zeros(1, 3, 8, 32, 32)
    want = _analytic_flops(model, x)
    with torch.no_grad():
        got = timing.step_flops(lambda: model(x))
    assert got == want == 1623457792


def test_step_flops_of_a_train_step_is_linear_in_the_batch():
    """The SimCLR step (autocast on inside the count, forward and
    backward) at B=2 and B=4: a sample's count agrees within 1 % (the
    NT-Xent logits, the one product that grows faster, are tiny); the
    backward roughly doubles the forward."""
    counts = {}
    for batch in (2, 4):
        unit = BN.TrainUnit(BN.soak_config("float32"), BN.aug_config(True),
                            batch, BN.SMOKE_SHAPES[1:3], torch.device("cpu"))
        counts[batch] = (timing.step_flops(unit.step), unit.forward_flops())
    step2, fwd2 = counts[2]
    step4, fwd4 = counts[4]
    assert abs(step4 / 4 - step2 / 2) <= 0.01 * step2 / 2
    assert abs(fwd4 / 4 - fwd2 / 2) <= 0.01 * fwd2 / 2
    assert 2.5 * fwd2 < step2 < 3.2 * fwd2


# --------------------------------------------------------------------------
# the batch search
# --------------------------------------------------------------------------

class _Failing:
    """A unit class that raises ``exc`` in ``step`` at batch ``at``."""

    def __init__(self, real, at, exc):
        self.real, self.at, self.exc, self.built = real, at, exc, []

    def __call__(self, *args, **kw):
        unit = self.real(*args, **kw)
        batch = unit.frames.shape[0]
        self.built.append(batch)
        if batch == self.at:
            def step():
                raise self.exc("out of memory (test)")
            unit.step = step
        return unit


@pytest.mark.parametrize("module,attr,spec", [
    (BB, "TrainUnit", "r3d:4,2"), (EB, "EvalUnit", "r3d:4,2")])
def test_out_of_memory_moves_the_search_to_the_next_batch(
        module, attr, spec, tmp_path, monkeypatch, capsys):
    failing = _Failing(getattr(module, attr), 4,
                       torch.cuda.OutOfMemoryError)
    monkeypatch.setattr(module, attr, failing)
    out = tmp_path / "out.json"
    assert module.main([spec, "--smoke", "--device", "cpu", "--steps", "1",
                        "--chains", "1", "--out", str(out)]) == 0
    (rec,) = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert failing.built == [4, 2]
    assert rec["batch"] == 2 and rec["did_not_fit"] == [4]
    assert rec["oom_steps"] == 1
    assert json.load(open(out))["results"][0]["batch"] == 2


@pytest.mark.parametrize("module,attr,spec", [
    (BB, "TrainUnit", "r3d:4,2"), (EB, "EvalUnit", "r3d:4,2")])
def test_any_other_failure_ends_the_run_without_a_record(
        module, attr, spec, tmp_path, monkeypatch, capsys):
    failing = _Failing(getattr(module, attr), 4, RuntimeError)
    monkeypatch.setattr(module, attr, failing)
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="test"):
        module.main([spec, "--smoke", "--device", "cpu", "--out", str(out)])
    assert failing.built == [4]
    assert not out.exists()
    assert "{" not in capsys.readouterr().out


def test_no_batch_that_fits_is_an_error_record(monkeypatch, tmp_path,
                                               capsys):
    """Every candidate out of memory: the record says so, is merged as an
    error, and the exit code is 1."""
    failing = _Failing(BB.TrainUnit, 2, torch.cuda.OutOfMemoryError)
    monkeypatch.setattr(BB, "TrainUnit", failing)
    out = tmp_path / "out.json"
    assert BB.main(["r3d:2", "--smoke", "--device", "cpu", "--out",
                    str(out)]) == 1
    (rec,) = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec == {"net": "r3d", "error": "all batch candidates failed",
                   "did_not_fit": [2]}
    assert json.load(open(out))["results"] == [rec]
