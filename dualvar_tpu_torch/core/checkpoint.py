"""Checkpoint store, and the pretrained-backbone graft.

Counterpart of ``dualvar_tpu/core/checkpoint.py``, over ``torch.save``
files instead of orbax:

* ``CheckpointStore``: the reference's two retention policies side by side
  (utils/utils.py:18-44) with the JAX store's rules: a rolling ``latest/``
  that keeps the two newest epochs, and a ``best/`` that keeps the five
  best by ``metrics["acc"]`` (ties: the newer epoch ranks higher; a save
  without metrics ranks as 0.0), or every epoch under ``keep_all``. A save
  of an epoch not past the newest one is skipped, as orbax skips it.
  ``save_single`` / ``restore_single`` write and read one file.
* ``merge_matching_leaves`` / ``load_pretrained_backbone``: the tolerant
  intersection load of the reference's ``neq_load_customized``
  (utils/utils.py:112-137) after its key remap (classifier.py:362-366).

A checkpoint is the dict the trainers save (``{"epoch", "state_dict",
"best_acc", "optimizer", "scheduler", "generator", "iteration"}``),
written under ``model/latest/epoch{N}.pth.tar`` (and, where it is kept, a
hard link of it under ``model/best/``). A flat ``model/`` of
``epoch*.pth.tar`` files, which earlier versions of the port wrote, reads
as the latest store, as the JAX store reads a flat directory of steps.
A pretrain checkpoint's backbone is under ``backbone.*`` for the SimCLR
models and under ``encoder_q.backbone.*`` for MoCo: the query encoder, which
is what the JAX package's MoCo ``TaskState`` keeps as its ``params`` and
grafts.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

_EPOCH_FILE = re.compile(r"epoch(\d+)\.pth\.tar")
_METRICS = "metrics.json"
# where each model family keeps its backbone in a state_dict
BACKBONE_PREFIXES = ("backbone.", "encoder_q.backbone.")


def _epoch_files(directory: str) -> dict[int, str]:
    """epoch -> path of every ``epoch{N}.pth.tar`` directly in
    ``directory`` (empty if it does not exist)."""
    if not os.path.isdir(directory):
        return {}
    return {int(m.group(1)): os.path.join(directory, name)
            for name in os.listdir(directory)
            if (m := _EPOCH_FILE.fullmatch(name))}


def checkpoint_file(path: str) -> str:
    """``path`` itself if it is a file; in a directory, the newest epoch of a
    flat layout, else of its store's ``latest/`` (else ``best/``)."""
    if os.path.isfile(path):
        return path
    for sub in ("", "latest", "best"):
        found = _epoch_files(os.path.join(path, sub))
        if found:
            return found[max(found)]
    raise FileNotFoundError(f"no epoch*.pth.tar in {path!r}")


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a checkpoint file or directory, on the CPU."""
    ckpt = torch.load(checkpoint_file(path), map_location="cpu")
    return ckpt["state_dict"]


def _to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to the CPU, so that the
    training step may change the originals while the copy is written."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, _to_cpu(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _write_atomic(obj: Any, path: str) -> None:
    """``torch.save`` under a temporary name in the same directory, then a
    rename into place: a crash mid-write never leaves a torn file under
    ``path``."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointStore:
    """Rolling ``latest/`` (2 kept) and best-k ``best/`` (5 by
    ``metrics["acc"]``, or every epoch under ``keep_all``) under
    ``directory``; see the module docstring.

    With ``async_save`` the state is copied to CPU tensors before ``save``
    returns and the file is written by one background thread; ``restore``,
    ``close``, ``wait_until_finished`` and the next ``save`` wait for it, and
    re-raise what it raised. The epochs each policy keeps are decided in
    ``save`` itself, so ``latest_epoch`` and ``best_epoch`` count an
    in-flight save, as the JAX store does.
    """

    def __init__(self, directory: str, keep_all: bool = False,
                 best_k: int = 5, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep_all = keep_all
        self.best_k = best_k
        self.async_save = async_save
        # a flat directory of epoch files is the latest store alone
        self._flat = bool(_epoch_files(self.directory))
        self.latest_dir = self.directory if self._flat else os.path.join(
            self.directory, "latest")
        self.best_dir = None if self._flat else os.path.join(
            self.directory, "best")
        for d in (self.latest_dir, self.best_dir):
            if d is not None:
                os.makedirs(d, exist_ok=True)
                for name in os.listdir(d):  # a write cut short
                    if name.endswith(".tmp"):
                        os.remove(os.path.join(d, name))
        self._pool: ThreadPoolExecutor | None = None
        self._pending: Future | None = None
        self._scan()

    def _scan(self) -> None:
        """Read which epochs each policy holds (and their accuracies) from
        the disk."""
        self._latest = sorted(_epoch_files(self.latest_dir))
        self._best: dict[int, float] = {}
        if self.best_dir is not None:
            accs = {}
            index = os.path.join(self.best_dir, _METRICS)
            if os.path.exists(index):
                with open(index) as fh:
                    accs = {int(k): v for k, v in json.load(fh).items()}
            self._best = {e: accs.get(e, 0.0)
                          for e in sorted(_epoch_files(self.best_dir))}

    # -- bookkeeping -------------------------------------------------------

    def latest_epoch(self) -> int | None:
        return self._latest[-1] if self._latest else None

    def best_epoch(self) -> int | None:
        """The best epoch by accuracy, the newer of a tie; the latest epoch
        under ``keep_all`` or in a flat store."""
        if self.best_dir is None or self.keep_all:
            return self.latest_epoch()
        if not self._best:
            return None
        return self._ranked()[-1]

    def _ranked(self) -> list[int]:
        """Best epochs from worst to best: ascending accuracy, the older
        epoch first among equals (orbax's stable sort of its steps)."""
        return sorted(self._best, key=lambda e: (self._best[e], e))

    def _path(self, directory: str, epoch: int) -> str:
        return os.path.join(directory, f"epoch{epoch}.pth.tar")

    # -- save / restore ----------------------------------------------------

    def save(self, epoch: int, state: dict,
             metrics: dict[str, float] | None = None) -> bool:
        """Save ``state`` as ``epoch``; False (nothing written) if ``epoch``
        is not past the newest saved epoch."""
        self.wait_until_finished()
        if self._latest and epoch <= self._latest[-1]:
            return False
        snapshot = _to_cpu(state)
        self._latest.append(epoch)
        drop_latest = self._latest[:-2]
        self._latest = self._latest[-2:]
        drop_best: list[int] = []
        if self.best_dir is not None:
            self._best[epoch] = float((metrics or {}).get("acc", 0.0))
            if not self.keep_all:
                ranked = self._ranked()
                drop_best = ranked[:-self.best_k]
                for e in drop_best:
                    del self._best[e]
        best_index = dict(self._best)
        job = (epoch, snapshot, drop_latest, drop_best, best_index)
        if self.async_save:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(1)
            self._pending = self._pool.submit(self._write, *job)
        else:
            try:
                self._write(*job)
            except BaseException:
                self._scan()
                raise
        return True

    def _write(self, epoch, snapshot, drop_latest, drop_best, best_index):
        latest = self._path(self.latest_dir, epoch)
        _write_atomic(snapshot, latest)
        if self.best_dir is not None and epoch in best_index:
            best = self._path(self.best_dir, epoch)
            try:  # one file on disk for both policies
                os.link(latest, best + ".tmp")
            except OSError:
                shutil.copyfile(latest, best + ".tmp")
            os.replace(best + ".tmp", best)
        for directory, dropped in ((self.latest_dir, drop_latest),
                                   (self.best_dir, drop_best)):
            for e in dropped:
                path = self._path(directory, e)
                if os.path.exists(path):
                    os.remove(path)
        if self.best_dir is not None:
            with open(os.path.join(self.best_dir, _METRICS + ".tmp"),
                      "w") as fh:
                json.dump({str(e): a for e, a in best_index.items()}, fh)
            os.replace(os.path.join(self.best_dir, _METRICS + ".tmp"),
                       os.path.join(self.best_dir, _METRICS))

    def wait_until_finished(self) -> None:
        """Block until the in-flight save has landed; re-raise its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                pending.result()
            except BaseException:
                self._scan()  # the failed epoch is not in the store
                raise

    def restore(self, epoch: int | None = None) -> dict:
        """The checkpoint of ``epoch`` (default: the latest), on the CPU,
        from ``latest/`` or else ``best/``."""
        self.wait_until_finished()
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        for directory in (self.latest_dir, self.best_dir):
            if directory is not None and os.path.exists(
                    self._path(directory, epoch)):
                return torch.load(self._path(directory, epoch),
                                  map_location="cpu")
        raise FileNotFoundError(
            f"epoch {epoch} not found under {self.directory}")

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None


def save_single(path: str, state: Any) -> None:
    """One-shot save of ``state`` (copied to the CPU) to ``path``."""
    _write_atomic(_to_cpu(state), os.path.abspath(path))


def restore_single(path: str) -> Any:
    return torch.load(os.path.abspath(path), map_location="cpu")


def merge_matching_leaves(dst: dict[str, torch.Tensor],
                          src: dict[str, torch.Tensor], logger=None,
                          strict: bool = False, prefix: str = ""
                          ) -> tuple[dict[str, torch.Tensor],
                                     dict[str, list[str]]]:
    """Copy every ``src`` entry whose key exists in ``dst`` with the same
    shape; keep the ``dst`` entry otherwise.

    Returns (merged, report) with report keys 'loaded', 'missing_in_src'
    (dst entries kept at their fresh init) and 'unused_src' (src entries
    with no matching dst key or a mismatched shape; a mismatched key is in
    both lists). ``strict=True`` raises unless the two match exactly.
    """
    remaining = dict(src)
    report = {"loaded": [], "missing_in_src": [], "unused_src": []}
    merged = {}
    for key, leaf in dst.items():
        s = remaining.pop(key, None)
        if s is not None and tuple(s.shape) == tuple(leaf.shape):
            merged[key] = s
            report["loaded"].append(prefix + key)
        else:
            if s is not None:  # present but shape-mismatched
                report["unused_src"].append(
                    f"{prefix}{key} (shape {tuple(s.shape)} vs "
                    f"{tuple(leaf.shape)})")
            merged[key] = leaf
            report["missing_in_src"].append(prefix + key)
    report["unused_src"].extend(prefix + k for k in remaining)
    if strict and (report["missing_in_src"] or report["unused_src"]):
        raise ValueError(
            "strict load: state_dicts do not match; "
            f"not loaded: {report['missing_in_src'][:8]}; "
            f"unused from checkpoint: {report['unused_src'][:8]}")
    if logger:
        # mirrors the reference's '=======Check Weights Loaded======' report
        logger.info(
            f"partial load{' ' + prefix if prefix else ''}: "
            f"{len(report['loaded'])} leaves loaded, "
            f"{len(report['missing_in_src'])} kept at init, "
            f"{len(report['unused_src'])} unused from checkpoint")
        for k in report["missing_in_src"]:
            logger.info(f"  not loaded (kept init): {k}")
        for k in report["unused_src"]:
            logger.info(f"  unused from checkpoint: {k}")
    return merged, report


def pretrain_backbone(state: dict[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """The backbone entries of a pretrain ``state_dict``, keys relative to
    the backbone: ``backbone.*`` (SimCLR) or ``encoder_q.backbone.*``
    (MoCo's query encoder)."""
    for pre in BACKBONE_PREFIXES:
        sub = {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
        if sub:
            return sub
    raise KeyError("the checkpoint holds no backbone (no key starts with "
                   f"{' or '.join(BACKBONE_PREFIXES)})")


def load_pretrained_backbone(classifier_state: dict[str, torch.Tensor],
                             pretrain_state: dict[str, torch.Tensor],
                             logger=None, strict: bool = False
                             ) -> tuple[dict[str, torch.Tensor],
                                        dict[str, list[str]]]:
    """Graft the pretrain encoder's backbone (weights and batch-norm running
    statistics) into a classifier ``state_dict``: every ``backbone.*`` entry
    whose key and shape match is loaded, every other classifier entry
    (``final_fc``, ``final_bn``) keeps its fresh init. Returns the new
    ``state_dict`` and the report of ``merge_matching_leaves`` over the
    backbone."""
    pre = "backbone."
    dst = {k[len(pre):]: v for k, v in classifier_state.items()
           if k.startswith(pre)}
    merged, report = merge_matching_leaves(
        dst, pretrain_backbone(pretrain_state), logger=logger, strict=strict,
        prefix=pre)
    out = dict(classifier_state)
    out.update({pre + k: v for k, v in merged.items()})
    return out, report
