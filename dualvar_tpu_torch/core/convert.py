"""Carry weights of the JAX package over to the port.

``from_jax_variables`` turns the flax ``params`` and ``batch_stats`` trees of
a JAX model (``SimCLRTimeSeriesV4``, ``SimCLRNaked``, ``LinearClassifier``;
nested dicts of arrays) into a ``state_dict`` for the port's module of the
same name. The port names its submodules after the flax tree, so the mapping
is mechanical:

* conv ``kernel (kt, kh, kw, I, O)`` -> ``weight (O, I, kt, kh, kw)``; a
  conv kernel the module holds as a parameter of its own (the packed S3D's
  ``conv1x1_kernel``, ``spatial_b1_kernel``, ...) keeps its name in the same
  layout;
* Dense ``kernel (I, O)`` -> ``weight (O, I)``;
* BN ``scale`` -> ``weight``; ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``;
* the JAX BatchNorm wrapper's inner ``bn`` level is collapsed
  (``bn1/bn/scale`` -> ``bn1.weight``, ``conv1/bn/bn/mean`` ->
  ``conv1.bn.running_mean``); a plain flax BatchNorm has no such level
  (the classifier's ``final_bn/scale`` -> ``final_bn.weight``).

``from_jax_task_state`` does the same for the MoCo models: the JAX
``TaskState`` (query ``params`` / ``batch_stats`` plus ``moco`` with
``params_k``, ``batch_stats_k``, ``queue``, ``series_queue``, ``ptr``) fills
the port's ``MoCo`` module (``encoder_q.*``, ``encoder_k.*``, ``queue``,
``series_queue``, ``queue_ptr``). Both queues are row-major in both packages.

Reference torch checkpoints (``{epoch, state_dict, best_acc, optimizer,
iteration}`` of the reference's pretrain.py:349-354) import through the key
grammar of ``dualvar_tpu/core/convert.py``: ``backbone_from_torch``,
``classifier_from_torch`` and ``ssl_from_torch`` rewrite each reference key
(``module.`` stripped) to the port's name of the same module. The port's
names are the flax tree's, so the JAX package's per-family maps give them
directly; both sides keep torch layouts, so no value is transposed. The
reference's 1x1x1 projection-head convolutions become the port's Linear
layers, and its ``(dim, K)`` MoCo queues the port's ``(K, dim)``.

CLI (writes a port checkpoint store)::

    python -m dualvar_tpu_torch.core.convert \\
        --ckpt reference/model/epoch199.pth.tar --net r21d --out converted

``--what backbone`` (or ``ssl``, the whole SSL model) gives a pretrain
checkpoint for ``--pretrain`` in either trainer; ``--what classifier`` a
finetuned classifier that the test protocols read with ``--resume``.
``--reverse`` exports a port checkpoint in the reference's format
(``backbone_to_torch`` / ``classifier_to_torch``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

_LEAF_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _convert_leaf(path: tuple[str, ...], value: np.ndarray):
    *scope, leaf = path
    if scope and scope[-1] == "bn" and leaf in ("scale", "bias", "mean", "var"):
        # BatchNorm wrapper: <name>/bn/<leaf> -> <name>.<leaf>
        scope = scope[:-1]
        leaf = _LEAF_NAMES.get(leaf, leaf)
    elif leaf.endswith("_kernel") and value.ndim == 5:
        value = value.transpose(4, 3, 0, 1, 2)
    elif leaf == "kernel":
        leaf = "weight"
        if value.ndim == 5:  # conv (kt, kh, kw, I, O) -> (O, I, kt, kh, kw)
            value = value.transpose(4, 3, 0, 1, 2)
        elif value.ndim == 2:  # Dense (I, O) -> (O, I)
            value = value.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {value.ndim}")
    elif leaf in _LEAF_NAMES:  # a plain flax BatchNorm
        leaf = _LEAF_NAMES[leaf]
    elif leaf != "bias":
        raise KeyError(f"unknown leaf {'/'.join(path)}")
    # a copy: the source array may be read-only or a transposed view
    return ".".join([*scope, leaf]), torch.from_numpy(
        np.array(value, dtype=np.float32, order="C"))


def from_jax_variables(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any],
                       module: torch.nn.Module | None = None
                       ) -> dict[str, torch.Tensor]:
    """flax ``params`` + ``batch_stats`` -> port ``state_dict``.

    Every leaf of both trees is consumed into exactly one key. With
    ``module`` given, also checks that the keys are exactly the module's
    ``state_dict`` keys with matching shapes, so nothing is left unfilled.
    """
    state: dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree):
            key, tensor = _convert_leaf(path, value)
            if key in state:
                raise KeyError(f"two leaves map to {key}")
            state[key] = tensor
    if module is not None:
        _check_against(state, module)
    return state


def _check_against(state: dict[str, torch.Tensor],
                   module: torch.nn.Module) -> None:
    """Every key of the module filled, none left over, shapes equal."""
    want = module.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(
            f"state_dict mismatch: unfilled {missing[:5]}, "
            f"unconsumed {extra[:5]}")
    for key, tensor in state.items():
        if tuple(tensor.shape) != tuple(want[key].shape):
            raise ValueError(
                f"{key}: shape {tuple(tensor.shape)} != module's "
                f"{tuple(want[key].shape)}")


def from_jax_task_state(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any],
                        moco: Mapping[str, Any],
                        module: torch.nn.Module | None = None
                        ) -> dict[str, torch.Tensor]:
    """JAX MoCo ``TaskState`` (as numpy trees) -> ``state_dict`` of the
    port's ``MoCo`` module.

    ``moco`` maps ``params_k``, ``batch_stats_k``, ``queue``, ``ptr`` and,
    for the time-series model, ``series_queue`` (absent or None for the
    naked model). Every leaf is consumed into exactly one key; with
    ``module`` given, the keys and shapes are checked against it as
    ``from_jax_variables`` does.
    """
    known = {"params_k", "batch_stats_k", "queue", "series_queue", "ptr"}
    if set(moco) - known:
        raise KeyError(f"unknown MoCo state fields {sorted(set(moco) - known)}")
    state: dict[str, torch.Tensor] = {}
    for prefix, tree, stats in (
            ("encoder_q.", params, batch_stats),
            ("encoder_k.", moco["params_k"], moco["batch_stats_k"])):
        for key, tensor in from_jax_variables(tree, stats).items():
            state[prefix + key] = tensor
    for key, name in (("queue", "queue"), ("series_queue", "series_queue")):
        if moco.get(name) is not None:
            state[key] = torch.from_numpy(
                np.array(moco[name], dtype=np.float32, order="C"))
    state["queue_ptr"] = torch.tensor(int(np.asarray(moco["ptr"])),
                                      dtype=torch.long)
    if module is not None:
        _check_against(state, module)
    return state


# ------------------------------------------------- reference torch checkpoints

def _tensor(value) -> torch.Tensor:
    """A CPU tensor of ``value`` (a tensor or a numpy array), its own copy."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(value, order="C"))


def load_torch_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], int]:
    """A reference ``.pth.tar`` -> (its flat ``state_dict`` on the CPU,
    epoch). Takes full checkpoints and bare state dicts."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    epoch = raw.get("epoch", 0) if isinstance(raw, dict) else 0
    return {k: _tensor(v) for k, v in sd.items()}, int(epoch)


def _strip_module(sd: Mapping[str, Any]) -> dict[str, Any]:
    """DDP's ``module.`` prefix removed from every key."""
    return {k.removeprefix("module."): v for k, v in sd.items()}


def extract_backbone_state(sd: Mapping[str, Any]) -> dict[str, Any]:
    """The backbone's entries of a reference ``state_dict``, keys relative
    to it: pretrain checkpoints root it at ``encoder_q.0.`` (the reference's
    encoder_q is a ModuleList with the backbone first), classifier
    checkpoints at ``backbone.``; anything else is taken as backbone-rooted.
    """
    sd = _strip_module(sd)
    for prefix in ("encoder_q.0.", "backbone."):
        sub = {k.removeprefix(prefix): v for k, v in sd.items()
               if k.startswith(prefix)}
        if sub:
            return sub
    return sd


# per-family maps of a reference MODULE path (key minus its leaf) to the
# port's, or None to skip the key

_BLOCK = re.compile(r"^conv(\d)\.block1\.")          # r3d / r21d first block
_BLOCKS = re.compile(r"^conv(\d)\.blocks\.(\d+)\.")  # r3d / r21d extra blocks
_LAYER = re.compile(r"^layer(\d)\.(\d+)\.")          # resnet_2d3d stages


def _map_resnet_blocks(mod: str) -> str:
    """``conv{k}.block1.`` / ``conv{k}.blocks.{i}.`` -> ``layer{k-1}_block0.``
    / ``layer{k-1}_block{i+1}.``, and the shortcut's names."""
    if m := _BLOCK.match(mod):
        mod = f"layer{int(m.group(1)) - 1}_block0." + mod[m.end():]
    elif m := _BLOCKS.match(mod):
        mod = (f"layer{int(m.group(1)) - 1}_block{int(m.group(2)) + 1}."
               + mod[m.end():])
    mod = mod.replace("downsampleconv", "downsample_conv")
    return mod.replace("downsamplebn", "downsample_bn")


def _map_r3d(mod: str) -> str | None:
    # the reference wraps each full-3D conv in a one-conv module
    mod = _map_resnet_blocks(mod)
    return mod.replace(".temporal_spatial_conv", "") \
        .removesuffix("temporal_spatial_conv").rstrip(".") or None


def _map_r21d(mod: str) -> str | None:
    return _map_resnet_blocks(mod)


def _map_c3d(mod: str) -> str | None:
    return mod  # identical naming


def _map_s3d(mod: str) -> str | None:
    if mod.startswith("block"):
        return None  # duplicate registrations of the same modules
    # Sequential branches -> flat names (branch3.0 is a parameterless pool)
    mod = re.sub(r"\bbranch0\.0\b", "branch0", mod)
    for b in (1, 2, 3):
        mod = re.sub(rf"\bbranch{b}\.(\d)\b", rf"branch{b}_\g<1>", mod)
    return mod


def _map_r2d3d(mod: str) -> str | None:
    if m := _LAYER.match(mod):
        mod = f"layer{m.group(1)}_block{m.group(2)}." + mod[m.end():]
    mod = mod.replace("downsample.0", "downsample_conv")
    return mod.replace("downsample.1", "downsample_bn")


_MAPPERS: dict[str, Callable[[str], str | None]] = {
    "r3d": _map_r3d, "r21d": _map_r21d, "c3d": _map_c3d, "s3d": _map_s3d,
    "s3dg": _map_s3d, "r2d3d18": _map_r2d3d, "r50": _map_r2d3d,
}


def backbone_from_torch(sd: Mapping[str, Any], net: str
                        ) -> dict[str, torch.Tensor]:
    """A backbone-rooted reference ``state_dict`` -> the ``state_dict`` of
    the port's ``select_backbone(net)``. ``num_batches_tracked`` is
    dropped (the port's batch norm has none)."""
    if net not in _MAPPERS:
        raise NotImplementedError(
            f"no torch key mapping for backbone {net!r} "
            f"(supported: {sorted(_MAPPERS)})")
    mapper = _MAPPERS[net]
    out: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        mod, leaf = key.rsplit(".", 1)
        ours = mapper(mod)
        if ours is None or leaf == "num_batches_tracked":
            continue
        if f"{ours}.{leaf}" in out:
            raise KeyError(f"two reference keys map to {ours}.{leaf}")
        out[f"{ours}.{leaf}"] = _tensor(value)
    return out


def classifier_from_torch(sd: Mapping[str, Any], net: str
                          ) -> dict[str, torch.Tensor]:
    """A reference LinearClassifier ``state_dict`` -> the port's
    ``LinearClassifier``: the backbone, the optional ``final_bn`` and the
    ``final_fc`` Linear, whose index in the reference's Sequential depends
    on its dropout (model/classifier.py:34-46) — found as the one 2-D
    weight."""
    sd = _strip_module(sd)
    bb = {k.removeprefix("backbone."): v for k, v in sd.items()
          if k.startswith("backbone.")}
    if not bb:
        raise ValueError("no 'backbone.' keys: is this a classifier "
                         "checkpoint? Use --what backbone for pretrain ones.")
    out = {"backbone." + k: v for k, v in backbone_from_torch(bb, net).items()}
    fc = [k for k, v in sd.items() if k.startswith("final_fc.")
          and k.endswith(".weight") and v.ndim == 2]
    if len(fc) != 1:
        raise ValueError(
            f"expected exactly one final_fc Linear, found {fc} (the "
            "nonlinear two-Linear head has no counterpart in the port)")
    out["final_fc.weight"] = _tensor(sd[fc[0]])
    bias = fc[0].rsplit(".", 1)[0] + ".bias"
    if bias in sd:
        out["final_fc.bias"] = _tensor(sd[bias])
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        if f"final_bn.{leaf}" in sd:  # BatchNorm1d (model/classifier.py:29)
            out[f"final_bn.{leaf}"] = _tensor(sd[f"final_bn.{leaf}"])
    return out


def _head_from_conv1x1(sd: Mapping[str, Any], prefix: str, i0: int,
                       i1: int, into: str) -> dict[str, torch.Tensor]:
    """Two 1x1x1 Conv3d layers of a reference projection head
    (model/simclr.py:46-50,176-180) -> the port's ``MLPHead`` Linear layers
    ``{into}.fc1`` / ``{into}.fc2``: weight (O, I, 1, 1, 1) -> (O, I)."""
    out = {}
    for name, idx in (("fc1", i0), ("fc2", i1)):
        w = _tensor(sd[f"{prefix}.{idx}.weight"])
        out[f"{into}.{name}.weight"] = w.reshape(w.shape[0], w.shape[1])
        if f"{prefix}.{idx}.bias" in sd:
            out[f"{into}.{name}.bias"] = _tensor(sd[f"{prefix}.{idx}.bias"])
    return out


def ssl_from_torch(sd: Mapping[str, Any], net: str
                   ) -> dict[str, torch.Tensor]:
    """A reference SSL-model ``state_dict`` -> the ``state_dict`` of the
    port's model of the same family (weights only, as ``--pretrain`` loads
    it): the query encoder (``encoder_q.0`` backbone, ``encoder_q.{2,4}``
    clip head, model/simclr.py:42-50) and the series head
    (``series_proj_head[_q].{0,2}``); for MoCo also the key encoder
    (``encoder_k.*``, ``series_proj_head_k.*``), the queues (reference
    ``(dim, K)`` -> port ``(K, dim)``, both n_series-major) and
    ``queue_ptr``. SimCLR's keys are ``backbone.*``, ``clip_head.*``,
    ``series_head.*``; MoCo's the same under ``encoder_q.`` and
    ``encoder_k.``."""
    sd = _strip_module(sd)

    def encoder(prefix: str, series_prefix: str) -> dict[str, torch.Tensor]:
        bb = {k.removeprefix(prefix + ".0."): v for k, v in sd.items()
              if k.startswith(prefix + ".0.")}
        if not bb:
            return {}
        out = {"backbone." + k: v
               for k, v in backbone_from_torch(bb, net).items()}
        if f"{prefix}.2.weight" in sd:
            out.update(_head_from_conv1x1(sd, prefix, 2, 4, "clip_head"))
        if f"{series_prefix}.0.weight" in sd:
            out.update(_head_from_conv1x1(sd, series_prefix, 0, 2,
                                          "series_head"))
        return out

    is_moco = any(k.startswith("encoder_k.") for k in sd)
    query = encoder("encoder_q", "series_proj_head_q" if is_moco
                    else "series_proj_head")
    if not query:
        raise ValueError("no 'encoder_q.0.' keys: not an SSL pretrain "
                         "checkpoint")
    if not is_moco:
        return query
    out = {"encoder_q." + k: v for k, v in query.items()}
    out.update({"encoder_k." + k: v for k, v in encoder(
        "encoder_k", "series_proj_head_k").items()})
    for name in ("queue", "series_queue"):
        if name in sd:
            out[name] = _tensor(sd[name]).T.contiguous()
    if "queue_ptr" in sd:
        out["queue_ptr"] = _tensor(sd["queue_ptr"]).reshape(()).long()
    return out


# the reverse direction: port state_dicts -> the reference's key grammar
# (the JAX package's backbone_to_torch / classifier_to_torch); each map
# takes the port's MODULE path and what the module is ("conv5d", "bn",
# "dense")

def _inv_resnet_blocks(mod: str) -> str:
    if m := re.match(r"^layer(\d)_block(\d+)\.", mod):
        li, bi = int(m.group(1)), int(m.group(2))
        mod = (f"conv{li + 1}.block1." if bi == 0
               else f"conv{li + 1}.blocks.{bi - 1}.") + mod[m.end():]
    mod = mod.replace("downsample_conv", "downsampleconv")
    return mod.replace("downsample_bn", "downsamplebn")


def _inv_r3d(mod: str, kind: str) -> str:
    mod = _inv_resnet_blocks(mod)
    return mod + ".temporal_spatial_conv" if kind == "conv5d" else mod


def _inv_r21d(mod: str, kind: str) -> str:
    return _inv_resnet_blocks(mod)


def _inv_c3d(mod: str, kind: str) -> str:
    return mod


def _inv_s3d(mod: str, kind: str) -> str:
    mod = re.sub(r"\bbranch0\b", "branch0.0", mod)
    return re.sub(r"\bbranch([123])_(\d)\b", r"branch\1.\2", mod)


def _inv_r2d3d(mod: str, kind: str) -> str:
    if m := re.match(r"^layer(\d)_block(\d+)\.", mod):
        mod = f"layer{m.group(1)}.{m.group(2)}." + mod[m.end():]
    mod = mod.replace("downsample_conv", "downsample.0")
    return mod.replace("downsample_bn", "downsample.1")


_INV_MAPPERS: dict[str, Callable[[str, str], str]] = {
    "r3d": _inv_r3d, "r21d": _inv_r21d, "c3d": _inv_c3d, "s3d": _inv_s3d,
    "s3dg": _inv_s3d, "r2d3d18": _inv_r2d3d, "r50": _inv_r2d3d,
}


def backbone_to_torch(state: Mapping[str, torch.Tensor], net: str
                      ) -> dict[str, torch.Tensor]:
    """A port backbone ``state_dict`` -> the reference's (inverse of
    ``backbone_from_torch``), with ``num_batches_tracked`` 0 for every
    batch norm so that a strict torch load takes it."""
    if net not in _INV_MAPPERS:
        raise NotImplementedError(f"no torch export for backbone {net!r}")
    inv = _INV_MAPPERS[net]
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        mod, leaf = key.rsplit(".", 1)
        if f"{mod}.running_mean" in state:
            ref = inv(mod, "bn")
            out.setdefault(f"{ref}.num_batches_tracked",
                           torch.zeros((), dtype=torch.long))
        else:
            ref = inv(mod, "conv5d" if value.dim() == 5 and leaf == "weight"
                      else "dense")
        out[f"{ref}.{leaf}"] = _tensor(value)
    return out


def classifier_to_torch(state: Mapping[str, torch.Tensor], net: str
                        ) -> dict[str, torch.Tensor]:
    """A port ``LinearClassifier`` ``state_dict`` -> the reference's
    classifier (``backbone.*``, ``final_bn.*``, ``final_fc.1.*``: the
    layout with dropout, model/classifier.py:34-37)."""
    pre = "backbone."
    out = {pre + k: v for k, v in backbone_to_torch(
        {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)},
        net).items()}
    for leaf in ("weight", "bias"):
        if f"final_fc.{leaf}" in state:
            out[f"final_fc.1.{leaf}"] = _tensor(state[f"final_fc.{leaf}"])
    if "final_bn.weight" in state:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"final_bn.{leaf}"] = _tensor(state[f"final_bn.{leaf}"])
        out["final_bn.num_batches_tracked"] = torch.zeros((),
                                                          dtype=torch.long)
    return out


def _validate_backbone(state: dict[str, torch.Tensor], net: str,
                       logger=None) -> None:
    """Every entry of a fresh ``select_backbone(net)`` filled with its
    exact key and shape, none left over."""
    from ..models.backbones import select_backbone
    from .checkpoint import merge_matching_leaves

    module, _ = select_backbone(net)
    merge_matching_leaves(module.state_dict(), state, logger, strict=True,
                          prefix="backbone.")


def main(argv=None) -> None:
    import argparse

    from .checkpoint import CheckpointStore, checkpoint_file, pretrain_backbone
    from .logging import get_logger

    p = argparse.ArgumentParser(
        description="Import a reference PyTorch checkpoint into a port "
                    "checkpoint store (or, with --reverse, export one).")
    p.add_argument("--ckpt", required=True,
                   help="reference .pth.tar (with --reverse: a port "
                        "checkpoint file or store directory)")
    p.add_argument("--net", required=True, choices=sorted(_MAPPERS))
    p.add_argument("--out", required=True,
                   help="output CheckpointStore directory")
    p.add_argument("--what", default="auto",
                   choices=["auto", "backbone", "classifier", "ssl"],
                   help="backbone: the encoder's backbone only (for "
                        "--pretrain in either trainer); ssl: the whole SSL "
                        "model, heads, key encoder and queues included (for "
                        "--pretrain in the pretrain trainer); classifier: a "
                        "finetuned model (for --resume of the test "
                        "protocols)")
    p.add_argument("--no_validate", action="store_true",
                   help="skip the strict key and shape check (backbone "
                        "mode only)")
    p.add_argument("--reverse", action="store_true",
                   help="export: --ckpt is a port checkpoint, --out a "
                        "reference-format .pth.tar (pretrain-style "
                        "encoder_q.0.* for backbone, classifier-style "
                        "otherwise)")
    args = p.parse_args(argv)
    logger = get_logger()

    if args.reverse:
        ckpt = torch.load(checkpoint_file(args.ckpt), map_location="cpu")
        state, epoch = ckpt["state_dict"], ckpt.get("epoch", 0)
        if args.what in ("auto", "backbone"):
            sd = {"encoder_q.0." + k: v for k, v in backbone_to_torch(
                pretrain_backbone(state), args.net).items()}
        else:
            sd = classifier_to_torch(state, args.net)
        torch.save({"epoch": epoch, "state_dict": sd}, args.out)
        logger.info(f"exported {len(sd)} torch tensors (epoch {epoch}) to "
                    f"'{args.out}'")
        return

    sd, epoch = load_torch_checkpoint(args.ckpt)
    sd = _strip_module(sd)
    what = args.what
    if what == "auto":
        what = ("classifier" if not any(k.startswith("encoder_q.") for k in sd)
                and any(k.startswith("backbone.") for k in sd)
                else "backbone")
        logger.info(f"--what auto -> {what}")
    if what == "backbone":
        bb = backbone_from_torch(extract_backbone_state(sd), args.net)
        if not args.no_validate:
            _validate_backbone(bb, args.net, logger)
        state = {"backbone." + k: v for k, v in bb.items()}
    elif what == "ssl":
        state = ssl_from_torch(sd, args.net)
    else:
        state = classifier_from_torch(sd, args.net)

    store = CheckpointStore(args.out, keep_all=True)
    store.save(epoch, {"epoch": epoch, "state_dict": state})
    store.close()
    logger.info(f"wrote {len(state)} tensors (epoch {epoch}) to "
                f"'{args.out}'; use it as --pretrain (backbone, ssl) or as "
                "--resume of a test protocol (classifier)")


if __name__ == "__main__":
    main()
