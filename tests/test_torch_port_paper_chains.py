"""The port's paper chains (``scripts/paper_torch/``) against the JAX
package's (``scripts/paper/``), recorded on the CPU: each script runs under
``sh`` with a ``python`` shim that keeps its command
(``dualvar_tpu_torch/tools/paper_chain.py:chain_commands``); no trainer
takes a step.

* Every port command is the JAX command with ``dualvar_tpu`` replaced by
  ``dualvar_tpu_torch`` and, on the classifier's, ``--prefix <chain>
  --name_prefix <EXP_NAME>`` after the preset (repair (c)); the JAX chain
  is recorded with ``EXP_NAME=exp`` exported, the port's with it unset
  (repair (b): ``exp`` is the port's default for every stage).
* Every stage parses with both packages' parsers (their trainers replaced by
  stubs that keep the configuration) to the same value of every config
  field: the two configs have the same fields, none is the port's alone.
  The port's own flags (``--device``, ``--synthetic``, pretrain's
  ``--dtype``) are no config field and no chain passes them.
* Every ``--pretrain`` / ``--resume`` is the ``model/`` directory of an
  earlier stage of the chain; ``DATA_ROOT`` / ``DB_PATH`` reach every stage;
  the port's scripts exit 0 without them (repair (a)).
* Three tests pin the faults of the JAX chains that the port repairs,
  recording the JAX scripts as they are.
"""

import dataclasses
import os
import sys

import pytest

import dualvar_tpu.train.classifier as JC
import dualvar_tpu.train.pretrain as JP
from dualvar_tpu_torch.tools import paper_chain as PC
from dualvar_tpu_torch.train import classifier as TC
from dualvar_tpu_torch.train import pretrain as TP

import torch_port_util  # noqa: F401  (caps torch's threads)

JAX_SCRIPTS = os.path.join("scripts", "paper")
STAGE_SCRIPTS = ("pretrain.sh", "finetune.sh", "test.sh", "finetune_hmdb.sh",
                 "test_hmdb.sh", "test_retrieval.sh")
SCRIPTS = STAGE_SCRIPTS + ("finetune_test.sh", "run.sh", "all_in.sh")
# each script's stages, as stage scripts
CHAINED = {"finetune_test.sh": ("finetune.sh", "test.sh"),
           "run.sh": STAGE_SCRIPTS, "all_in.sh": STAGE_SCRIPTS}
DATA = {"DATA_ROOT": "/data/ucf101", "DB_PATH": "/data/frames"}
# config fields of one package only (dataclasses.asdict, flattened)
PORT_ONLY_FIELDS = frozenset()
JAX_ONLY_FIELDS = frozenset()


def _port_module(jax_module: str) -> str:
    assert jax_module.startswith("dualvar_tpu.train.")
    return "dualvar_tpu_torch" + jax_module[len("dualvar_tpu"):]


def _without_repair_c(chain: str, module: str, argv: list[str]) -> list[str]:
    """The classifier's argv without ``--prefix <chain> --name_prefix exp``,
    which must follow the preset."""
    if not module.endswith(".classifier"):
        return argv
    assert argv[2:6] == ["--prefix", chain, "--name_prefix", "exp"], argv
    return argv[:2] + argv[6:]


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("chain", PC.CHAINS)
def test_port_commands_are_the_jax_commands(chain, script):
    jax = PC.chain_commands(chain, script, dict(DATA, EXP_NAME="exp"),
                            scripts=JAX_SCRIPTS)
    port = PC.chain_commands(chain, script, DATA)
    assert len(port) == len(jax) == len(CHAINED.get(script, (script,)))
    for (jm, ja), (pm, pa) in zip(jax, port):
        assert pm == _port_module(jm)
        assert _without_repair_c(chain, pm, pa) == ja
    # an exported EXP_NAME wins in every stage, as in the JAX chains
    named = PC.chain_commands(chain, script, dict(DATA, EXP_NAME="run7"))
    assert [(m, [a.replace("run7", "exp") for a in argv])
            for m, argv in named] == port


def _flat(cfg) -> dict:
    out = {}

    def walk(d, pre):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, pre + k + ".")
            else:
                out[pre + k] = v

    walk(dataclasses.asdict(cfg), "")
    return out


def _capture(monkeypatch, module, names) -> dict:
    seen = {}
    for name in names:
        def stub(cfg, *args, _name=name, **kw):
            seen.update(called=_name, cfg=cfg)
            return {}

        monkeypatch.setattr(module, name, stub)
    return seen


TESTS = ("train", "test_retrieval", "test_temporal_tenclip", "test_multicrop")


def _parse_both(monkeypatch, module: str, argv: list[str]):
    """(JAX's captured call, the port's) of one recorded port stage."""
    if module.endswith(".pretrain"):
        jm, pm, names = JP, TP, ("train", "visualize")
    else:
        jm, pm, names = JC, TC, TESTS
    jax_seen = _capture(monkeypatch, jm, names)
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    jm.main()
    port_seen = _capture(monkeypatch, pm, names)
    pm.main(argv + ["--device", "cpu"])
    return jax_seen, port_seen


@pytest.mark.parametrize("script", STAGE_SCRIPTS)
@pytest.mark.parametrize("chain", PC.CHAINS)
def test_every_stage_parses_as_in_jax(chain, script, monkeypatch):
    [(module, argv)] = PC.chain_commands(chain, script, DATA)
    jax_seen, port_seen = _parse_both(monkeypatch, module, argv)
    assert jax_seen["called"] == port_seen["called"]
    j, p = _flat(jax_seen["cfg"]), _flat(port_seen["cfg"])
    assert set(p) - set(j) == PORT_ONLY_FIELDS
    assert set(j) - set(p) == JAX_ONLY_FIELDS
    assert {k: p[k] for k in j} == j
    # what each stage is: its preset's dataset and its run directory
    cfg = port_seen["cfg"]
    assert cfg.data.data_root == DATA["DATA_ROOT"]
    assert cfg.data.db_path == DATA["DB_PATH"]
    assert cfg.data.synthetic is False
    assert cfg.run.prefix == chain and cfg.run.name_prefix == "exp"


def _directory(module: str, argv: list[str]) -> tuple[str, object]:
    trainer = TP if module.endswith(".pretrain") else TC
    cfg, _ = trainer.config_from_argv(argv)
    return trainer.set_path(cfg, create=False), cfg


@pytest.mark.parametrize("exp_name", [None, "run7"])
@pytest.mark.parametrize("chain", PC.CHAINS)
def test_each_input_is_an_earlier_stage_model_dir(chain, exp_name):
    env = {} if exp_name is None else {"EXP_NAME": exp_name}
    stages = PC.chain_commands(chain, "run.sh", env)
    written = []
    reads = []
    for module, argv in stages:
        directory, cfg = _directory(module, argv)
        for path in (cfg.run.pretrain, cfg.run.resume):
            if path:
                assert path in [os.path.join(d, "model") for d in written], \
                    (module, argv, written)
                reads.append((os.path.basename(directory), path))
        written.append(directory)
    name = exp_name or "exp"
    pretrain = f"log/{chain}/pretrain/{name}"
    ft = f"log/{chain}/ft/{name}"
    assert written == [pretrain, f"{ft}/ucf", f"{ft}/ucf", f"{ft}/hmdb",
                       f"{ft}/hmdb", f"{ft}/ucf"]
    assert reads == [("ucf", f"{pretrain}/model"), ("ucf", f"{ft}/ucf/model"),
                     ("hmdb", f"{pretrain}/model"),
                     ("hmdb", f"{ft}/hmdb/model"),
                     ("ucf", f"{pretrain}/model")]


@pytest.mark.parametrize("env", [
    DATA, {"DATA_ROOT": DATA["DATA_ROOT"]}, {"DB_PATH": DATA["DB_PATH"]}],
    ids=["both", "data_root", "db_path"])
def test_data_variables_reach_every_stage(env):
    for chain in PC.CHAINS:
        for module, argv in PC.chain_commands(chain, "run.sh", env):
            want = []
            if "DATA_ROOT" in env:
                want += ["--data_root", env["DATA_ROOT"]]
            if "DB_PATH" in env:
                want += ["--db_path", env["DB_PATH"]]
            assert argv[-len(want):] == want
            _, cfg = _directory(module, argv)
            assert cfg.data.data_root == env.get("DATA_ROOT", "")
            assert cfg.data.db_path == env.get("DB_PATH", "")
            assert cfg.data.synthetic is False


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("chain", PC.CHAINS)
def test_port_scripts_run_without_data_variables(chain, script):
    """Repair (a): with neither variable set every script issues its
    commands (``chain_commands`` raises on a non-zero exit), none with a
    data flag."""
    stages = PC.chain_commands(chain, script)
    assert len(stages) == len(CHAINED.get(script, (script,)))
    for _, argv in stages:
        assert "--data_root" not in argv and "--db_path" not in argv


@pytest.mark.parametrize("chain", PC.CHAINS)
def test_jax_scripts_exit_1_without_db_path(chain):
    """Fault 1 of the JAX chains: ``scripts/paper/common.sh`` ends on
    ``[ -n "$DB_PATH" ] && ...`` under ``set -e``, so every script sourcing
    it stops with status 1 before it runs anything, DATA_ROOT set or not."""
    for script in ("pretrain.sh", "run.sh"):
        for env in ({}, {"DATA_ROOT": DATA["DATA_ROOT"]}):
            with pytest.raises(PC.ChainError) as err:
                PC.chain_commands(chain, script, env, scripts=JAX_SCRIPTS)
            assert err.value.returncode == 1 and err.value.stages == []


@pytest.mark.parametrize("chain", PC.CHAINS)
def test_jax_stages_are_named_after_their_scripts(chain):
    """Fault 2: without an exported EXP_NAME each JAX stage takes its own
    script's basename, so every input names a directory no stage writes."""
    stages = PC.chain_commands(chain, "run.sh", DATA, scripts=JAX_SCRIPTS)
    written = []
    for module, argv in stages:
        directory, cfg = _directory(_port_module(module), argv)
        for path in (cfg.run.pretrain, cfg.run.resume):
            if path:
                assert path not in [os.path.join(d, "model")
                                    for d in written], (argv, written)
        written.append(directory)
    assert written[0] == f"log/{chain}/pretrain/pretrain"
    assert stages[1][1][stages[1][1].index("--pretrain") + 1] == \
        f"log/{chain}/pretrain/finetune/model"
    assert stages[2][1][stages[2][1].index("--resume") + 1] == \
        f"log/{chain}/ft/test/ucf/model"


@pytest.mark.parametrize("chain", PC.CHAINS)
def test_jax_table2_tests_read_what_no_finetune_writes(chain):
    """Fault 3: even with EXP_NAME exported, the JAX finetunes pass no
    ``--prefix``, so they write under their preset's prefix
    (``paper_table1_k400``), and a table-2 chain's test stages read its own
    prefix, which no stage writes; table 1's chain is where the two
    agree."""
    stages = PC.chain_commands(chain, "run.sh", dict(DATA, EXP_NAME="exp"),
                               scripts=JAX_SCRIPTS)
    dirs = [_directory(_port_module(m), argv)[0] for m, argv in stages]
    finetunes = {dirs[1], dirs[3]}
    assert finetunes == {"log/paper_table1_k400/ft/exp/ucf",
                         "log/paper_table1_k400/ft/exp/hmdb"}
    resumes = {_directory(_port_module(m), argv)[1].run.resume
               for m, argv in (stages[2], stages[4])}
    assert resumes == {f"log/{chain}/ft/exp/ucf/model",
                       f"log/{chain}/ft/exp/hmdb/model"}
    read_what_was_written = resumes == {os.path.join(d, "model")
                                        for d in finetunes}
    assert read_what_was_written == (chain == "paper_table1_k400")
