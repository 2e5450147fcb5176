"""Record and replay the paper's experiment chains (``scripts/paper_torch/``).

``chain_commands`` runs one of a chain's shell scripts with a ``python``
(and ``python3``) shim first on ``PATH``: the shim writes its arguments as
one JSON line and exits 0, so what comes back is each command the script
would issue for a user, in order, with the shell logic of ``common.sh`` and
of the chain run as written. Pointed at ``scripts/paper/`` it records the
JAX package's chains the same way.

``run_chain`` replays recorded stages in this process, through
``train/pretrain.py:main`` and ``train/classifier.py:main``, from the
working directory the recorded ``log/...`` paths are relative to. Before a
stage it checks that each ``--pretrain`` / ``--resume`` it names exists and
lies in the directory of an earlier stage of the replay. Each stage starts
from the backend flags, the ``DUALVAR_BN_STATS`` variable and the logger as
the replay found them (a stage logs to its own directory), and all of them
are as found when the replay returns; the trainers draw only from their
own generators and seeded forks of the global one. A stage that raises
ends the replay with its exception. Being in process, the kernels' launch
counters see every stage.

Command line (a short rehearsal of a chain from the repo root, where the
scripts write; the flags after ``--`` go to every stage):

    python3 -m dualvar_tpu_torch.tools.paper_chain --chain paper_table1_k400 \\
        -- --synthetic 1 --epochs 1 --max_steps 2
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import logging
import os
import shlex
import subprocess
import sys
import tempfile
import time
from typing import Any, NamedTuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT_SCRIPTS = os.path.join("scripts", "paper_torch")
CHAINS = ("paper_table1_k400", "paper_table2_moco_r21d",
          "paper_table2_re_simclr_r21d")
# the variables the chains read; one not given to chain_commands is unset
CHAIN_VARS = ("DATA_ROOT", "DB_PATH", "EXP_NAME")
RECORD_VAR = "PAPER_CHAIN_RECORD"
TRAINERS = ("dualvar_tpu_torch.train.pretrain",
            "dualvar_tpu_torch.train.classifier")
LOGGER = "dualvar_tpu_torch"  # core/logging.py:get_logger's default name

_RECORDER = ("import json, os, sys\n"
             f"with open(os.environ[{RECORD_VAR!r}], 'a') as f:\n"
             "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")


class ChainError(RuntimeError):
    """A chain's script exited non-zero; ``stages`` holds what it issued
    before."""

    def __init__(self, script: str, returncode: int, stderr: str,
                 stages: list[tuple[str, list[str]]]):
        super().__init__(f"{script} exited {returncode} after {len(stages)} "
                         f"command(s): {stderr.strip()[-2000:]}")
        self.returncode, self.stages = returncode, stages


def chain_commands(chain: str, script: str = "run.sh",
                   env: dict[str, str] | None = None,
                   scripts: str = PORT_SCRIPTS
                   ) -> list[tuple[str, list[str]]]:
    """The commands ``sh <scripts>/<chain>/<script>`` issues, in order, as
    ``(module, argv)`` of each ``python -m module argv...``. ``env`` gives
    the chains' variables (``CHAIN_VARS``); the ones it does not give are
    unset, whatever this process's environment holds. Raises
    ``ChainError`` if the script exits non-zero."""
    path = os.path.join(REPO, scripts, chain, script)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with tempfile.TemporaryDirectory(prefix="paper_chain_") as shims:
        record = os.path.join(shims, "record.jsonl")
        for name in ("python", "python3"):
            shim = os.path.join(shims, name)
            with open(shim, "w") as fh:
                fh.write(f"#!/bin/sh\nexec {shlex.quote(sys.executable)} -I "
                         f"-S -c {shlex.quote(_RECORDER)} \"$@\"\n")
            os.chmod(shim, 0o755)
        run_env = {k: v for k, v in os.environ.items() if k not in CHAIN_VARS}
        run_env.update(env or {})
        run_env["PATH"] = shims + os.pathsep + os.environ.get("PATH", "")
        run_env[RECORD_VAR] = record
        done = subprocess.run(["sh", path], cwd=REPO, env=run_env,
                              capture_output=True, text=True, timeout=120)
        stages = []
        if os.path.exists(record):
            with open(record) as fh:
                for line in fh:
                    argv = json.loads(line)
                    if len(argv) < 2 or argv[0] != "-m":
                        raise ValueError(f"{path} ran python without -m: "
                                         f"{argv}")
                    stages.append((argv[1], argv[2:]))
    if done.returncode != 0:
        raise ChainError(path, done.returncode, done.stderr, stages)
    return stages


class Stage(NamedTuple):
    """One replayed stage."""

    module: str
    argv: list[str]  # as replayed: the recorded argv, then extra_argv
    directory: str  # absolute: the trainer's set_path of the stage's config
    config: Any  # the stage's PretrainConfig or ClassifierConfig
    seconds: float  # wall time of the trainer's main
    log: list[str]  # the messages the stage logged
    result: Any  # what the trainer's main returned
    launches: dict[str, int]  # kernel launches, by the counters given


def stage_name(module: str, argv: list[str]) -> str:
    """How printed lines name a stage: the trainer, the preset and, for the
    classifier, ``--test``."""
    words = [module.rsplit(".", 1)[-1]]
    for flag in ("--preset", "--test"):
        if flag in argv[:-1]:
            words.append(argv[argv.index(flag) + 1])
    return " ".join(words)


class _Messages(logging.Filter):
    """Keeps every message that reaches the logger; drops none."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def filter(self, record: logging.LogRecord) -> bool:
        self.lines.append(record.getMessage())
        return True


@contextlib.contextmanager
def _as_found(cwd: str):
    """Runs the block in ``cwd`` and gives it a callable that puts the
    backend flags and ``DUALVAR_BN_STATS`` back as they were when the block
    began (called before each stage); restores those, the logger and the
    working directory when the block ends."""
    import torch

    cudnn = torch.backends.cudnn
    flags = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
             torch.get_float32_matmul_precision())
    bn_stats = os.environ.get("DUALVAR_BN_STATS")
    # the caller's handlers are detached for the block: each stage's
    # get_logger then sets up its own, logging to its own directory
    logger = logging.getLogger(LOGGER)
    handlers = list(logger.handlers)
    level, propagate = logger.level, logger.propagate
    for handler in handlers:
        logger.removeHandler(handler)
    here = os.getcwd()

    def reset():
        (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic) = flags[:3]
        torch.set_float32_matmul_precision(flags[3])
        if bn_stats is None:
            os.environ.pop("DUALVAR_BN_STATS", None)
        else:
            os.environ["DUALVAR_BN_STATS"] = bn_stats

    os.chdir(cwd)
    try:
        yield reset
    finally:
        os.chdir(here)
        reset()
        for handler in handlers:
            logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = propagate


def _check_inputs(i: int, module: str, cfg, cwd: str,
                  written: list[str]) -> None:
    """Each ``--pretrain`` / ``--resume`` of stage ``i`` exists and lies in
    a directory an earlier stage wrote (``auto``: the stage's own store)."""
    for flag in ("pretrain", "resume"):
        path = getattr(cfg.run, flag)
        if not path or path == "auto":
            continue
        full = os.path.normpath(os.path.join(cwd, path))
        if not os.path.exists(full):
            raise FileNotFoundError(
                f"stage {i} ({module}): --{flag} {path!r} does not exist")
        if not any(full == d or full.startswith(d + os.sep)
                   for d in written):
            raise ValueError(
                f"stage {i} ({module}): --{flag} {path!r} was written by no "
                f"earlier stage of this replay (they wrote {written})")


def run_chain(stages: list[tuple[str, list[str]]],
              extra_argv: list[str] | tuple = (), cwd: str = ".",
              counters: dict[str, Any] | None = None) -> list[Stage]:
    """Replays ``stages`` (``chain_commands``'s) in order in this process,
    each with ``extra_argv`` appended, from the working directory ``cwd``.
    ``counters``: name -> object with a ``.launches`` count (the kernels'
    wrappers); each stage's launches are the counts' growth over it.
    A process group of the caller's would be destroyed by the first stage:
    replay from a process outside any group."""
    cwd = os.path.abspath(cwd)
    counters = counters or {}
    done: list[Stage] = []
    logger = logging.getLogger(LOGGER)
    with _as_found(cwd) as reset:
        for i, (module, argv) in enumerate(stages):
            if module not in TRAINERS:
                raise ValueError(f"stage {i}: {module} is not a trainer of "
                                 f"the port ({', '.join(TRAINERS)})")
            trainer = importlib.import_module(module)
            argv = list(argv) + list(extra_argv)
            cfg, _ = trainer.config_from_argv(argv)
            _check_inputs(i, module, cfg, cwd, [s.directory for s in done])
            directory = os.path.normpath(os.path.join(
                cwd, trainer.set_path(cfg, create=False)))
            reset()
            messages = _Messages()
            logger.addFilter(messages)
            before = {n: c.launches for n, c in counters.items()}
            try:
                tic = time.perf_counter()
                result = trainer.main(argv)
                seconds = time.perf_counter() - tic
            finally:
                logger.removeFilter(messages)
                for handler in list(logger.handlers):
                    handler.close()
                    logger.removeHandler(handler)
            done.append(Stage(
                module, argv, directory, cfg, seconds, messages.lines, result,
                {n: c.launches - before[n] for n, c in counters.items()}))
    return done


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Replay a chain's run.sh of scripts/paper_torch/ in one "
                    "process from the repo root; the flags after -- go to "
                    "every stage. DATA_ROOT, DB_PATH and EXP_NAME are read "
                    "from the environment, as the scripts read them.")
    p.add_argument("--chain", required=True, choices=CHAINS)
    p.add_argument("extra", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    extra = args.extra[1:] if args.extra[:1] == ["--"] else args.extra
    stages = chain_commands(args.chain, env={
        k: os.environ[k] for k in CHAIN_VARS if k in os.environ})
    tic = time.perf_counter()
    for stage in run_chain(stages, extra, cwd=REPO):
        print(f"{stage_name(stage.module, stage.argv)}: "
              f"{stage.seconds:.2f} s, {stage.directory}", flush=True)
    print(f"{args.chain}: {len(stages)} stages in "
          f"{time.perf_counter() - tic:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
