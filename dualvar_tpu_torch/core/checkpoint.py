"""Pretrained-backbone graft: load what matches of a pretrain checkpoint
into a classifier.

Counterpart of ``merge_matching_leaves`` and ``load_pretrained_backbone`` of
``dualvar_tpu/core/checkpoint.py``, over ``state_dict``s: the tolerant
intersection load of the reference's ``neq_load_customized``
(utils/utils.py:112-137) after its key remap (classifier.py:362-366). The
checkpoint store of the JAX package (best-k retention, resume of training)
is not ported yet (ROADMAP.md, A.11).

A pretrain checkpoint is the file ``train/pretrain.py`` writes
(``{"epoch", "state_dict", "best_acc", "optimizer", "iteration"}``), or the
``model/`` directory that holds such files. Its backbone is under
``backbone.*`` for the SimCLR models and under ``encoder_q.backbone.*`` for
MoCo: the query encoder, which is what the JAX package's MoCo ``TaskState``
keeps as its ``params`` and grafts.
"""

from __future__ import annotations

import os
import re

import torch

_EPOCH_FILE = re.compile(r"epoch(\d+)\.pth\.tar$")
# where each model family keeps its backbone in a state_dict
BACKBONE_PREFIXES = ("backbone.", "encoder_q.backbone.")


def checkpoint_file(path: str) -> str:
    """``path`` itself if it is a file, else the newest (highest epoch)
    ``epoch*.pth.tar`` in the directory ``path``."""
    if os.path.isfile(path):
        return path
    found = [(int(m.group(1)), name) for name in os.listdir(path)
             if (m := _EPOCH_FILE.search(name))]
    if not found:
        raise FileNotFoundError(f"no epoch*.pth.tar in {path!r}")
    return os.path.join(path, max(found)[1])


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a checkpoint file or directory, on the CPU."""
    ckpt = torch.load(checkpoint_file(path), map_location="cpu")
    return ckpt["state_dict"]


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
