"""Carry weights of the JAX package over to the port.

``from_jax_variables`` turns the flax ``params`` and ``batch_stats`` trees of
a JAX model (``SimCLRTimeSeriesV4``, ``SimCLRNaked``, ``LinearClassifier``;
nested dicts of arrays) into a ``state_dict`` for the port's module of the
same name. The port names its submodules after the flax tree, so the mapping
is mechanical:

* conv ``kernel (kt, kh, kw, I, O)`` -> ``weight (O, I, kt, kh, kw)``;
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
"""

from __future__ import annotations

from typing import Any, Mapping

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
