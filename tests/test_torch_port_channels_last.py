"""The backbones' activations in ``channels_last_3d`` memory
(``dualvar_tpu_torch/models/layers.py:card_layout``), on the CPU at the
tiny sizes of the other backbone tests.

On the card every backbone's ``forward`` puts its input in
``channels_last_3d`` memory and cuDNN keeps it; on the CPU ``card_layout``
leaves a tensor as it is, so these tests put the layout in themselves
(``_channels_last``) and compare with the NCDHW run:

* float32, as the CPU's oneDNN convolutions keep the layout as cuDNN does:
  every ``Conv3d`` input and the output are channels-last (``nchw_convs``
  0 in a step, every convolution counted in the NCDHW step), the eval
  forward within 1e-5, and in one SimCLR-TSV4 and one MoCo train step the
  losses and running statistics within 1e-5;
* float64, with each ``Conv3d``'s output put back in channels-last memory
  (the CPU's float64 convolution returns NCDHW): the output, the input's
  and every parameter's gradient and the running statistics within 1e-6
  of the NCDHW run, backbone by backbone and in the two train steps.
  Gradients are compared in float64 because in float32 the two layouts'
  rounding puts a value that lies within rounding of ReLU's kink, or of a
  max pool's tie, on either side of it, and either side's subgradient
  then flows back whole: at these sizes a single such value moved whole
  gradients by 3e-4 to 0.9 relative.
"""

import contextlib
import dataclasses

import pytest
import torch

from dualvar_tpu_torch.core import spans
from dualvar_tpu_torch.core.config import PRETRAIN_PRESETS
from dualvar_tpu_torch.models import backbones
from dualvar_tpu_torch.models.backbones import (c3d, r3d, r21d, resnet_2d3d,
                                                s3dg, select_backbone)
from dualvar_tpu_torch.models.layers import BatchNorm, Conv3d, card_layout
from dualvar_tpu_torch.train import pretrain
from dualvar_tpu_torch.train.tasks import total_loss

import torch_port_util  # noqa: F401  (caps torch's threads)

CL = torch.channels_last_3d
B, T, S = 2, 8, 32
NETS = ("r21d", "r21d_pad128", "s3d", "s3dg", "r3d", "c3d", "r2d3d18")
_MODULES = (r21d, s3dg, r3d, c3d, resnet_2d3d)


def _is_cl(t: torch.Tensor) -> bool:
    return t.is_contiguous(memory_format=CL)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


@contextlib.contextmanager
def _channels_last(model: torch.nn.Module, keep_conv_outputs: bool):
    """Inside the block every backbone's ``forward`` puts a 5-D input in
    ``channels_last_3d`` memory, CPU tensors too, as ``card_layout`` does
    with the card's; with ``keep_conv_outputs`` each ``Conv3d`` of
    ``model`` also returns its output in that memory."""
    saved = {m: m.card_layout for m in _MODULES}
    handles = []
    try:
        for m in _MODULES:
            m.card_layout = lambda x: (x.contiguous(memory_format=CL)
                                       if x.dim() == 5 else x)
        if keep_conv_outputs:
            handles = [mod.register_forward_hook(
                lambda mod, args, out: out.contiguous(memory_format=CL))
                for mod in model.modules() if isinstance(mod, Conv3d)]
        yield
    finally:
        for m, fn in saved.items():
            m.card_layout = fn
        for h in handles:
            h.remove()


def test_card_layout_leaves_cpu_tensors_as_they_are():
    for x in (torch.randn(2, 3, 4, 5, 6), torch.randn(2, 3, 4, 5),
              torch.randn(2, 3, 4, 5, 6).permute(0, 2, 1, 3, 4),
              torch.randn(2, 3, 4, 5, 6).contiguous(memory_format=CL)):
        y = card_layout(x)
        assert y is x and y.stride() == x.stride()


def _backbone(net: str, dtype: torch.dtype) -> torch.nn.Module:
    torch.manual_seed(len(net))
    model, _ = select_backbone(net)
    return model.to(dtype)


def _inputs(dtype):
    g = torch.Generator().manual_seed(5)
    return torch.randn((B, 3, T, S, S), generator=g).to(dtype)


@pytest.mark.parametrize("net", NETS)
def test_backbone_keeps_the_layout_through_its_stages(net):
    """float32 as oneDNN computes it: a channels-last input reaches every
    convolution and batch norm in channels-last memory and comes out in it
    (``nchw_convs`` 0 in the step, forward and backward); an NCDHW input
    counts every convolution call but those on a map of one position,
    which is both layouts at once; the eval forward agrees within 1e-5."""
    model = _backbone(net, torch.float32).train()
    x = _inputs(torch.float32)
    seen = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, args: seen.append((isinstance(mod, Conv3d),
                                       _is_cl(args[0]))))
        for mod in model.modules() if isinstance(mod, (Conv3d, BatchNorm))]
    counts = {}
    for name, layout in (("nchw", False), ("cl", True)):
        seen.clear()
        spans.reset()
        with _channels_last(model, keep_conv_outputs=False) if layout \
                else contextlib.nullcontext():
            with spans.span(spans.STEP):
                y = model(x)
                y.float().square().mean().backward()
        counts[name] = spans.steps()[-1]["counts"].get("nchw_convs", 0)
        if layout:
            assert all(cl for _, cl in seen) and _is_cl(y), seen
        else:
            one_position = sum(conv and cl for conv, cl in seen)
    for h in hooks:
        h.remove()
    spans.reset()
    n_convs = sum(isinstance(m, Conv3d) for m in model.modules())
    assert one_position < n_convs / 4
    assert counts == {"nchw": n_convs - one_position, "cl": 0}

    model.eval()
    with torch.no_grad():
        want = model(x)
        with _channels_last(model, keep_conv_outputs=False):
            got = model(x)
    assert _is_cl(got)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("net,bn_stats", [(n, None) for n in NETS]
                         + [("r21d", "pallas")])
def test_backbone_computes_the_same_in_either_layout_in_float64(
        net, bn_stats, monkeypatch):
    """One train-mode forward and backward: the output, the input's
    gradient, every parameter's gradient and the running statistics; ATen's
    batch norm, and for R(2+1)D also the one-pass route
    (``DUALVAR_BN_STATS=pallas``, ``_OnePassBN``)."""
    if bn_stats:
        monkeypatch.setenv("DUALVAR_BN_STATS", bn_stats)
    else:
        monkeypatch.delenv("DUALVAR_BN_STATS", raising=False)
    x = _inputs(torch.float64)
    runs = []
    state = _backbone(net, torch.float64).state_dict()
    for layout in (False, True):
        model = _backbone(net, torch.float64).train()
        model.load_state_dict(state)
        xx = x.clone().requires_grad_()
        with _channels_last(model, keep_conv_outputs=True) if layout \
                else contextlib.nullcontext():
            y = model(xx)
            w = torch.randn(y.shape, dtype=y.dtype,
                            generator=torch.Generator().manual_seed(6))
            (y * w).sum().backward()
        if layout:
            assert _is_cl(y)
        runs.append({"out": y.detach(), "dx": xx.grad,
                     **{f"grad.{k}": p.grad
                        for k, p in model.named_parameters()},
                     **{f"buf.{k}": b for k, b in model.named_buffers()}})
    want, got = runs
    scale = max(float(v.norm()) for k, v in want.items()
                if k.startswith("grad."))
    for k, v in want.items():
        err = float((got[k].double() - v.double()).norm())
        if k.startswith("grad.") and float(v.norm()) < 1e-9 * scale:
            assert err <= 1e-12 * scale, k  # a gradient that is zero
        else:
            assert err <= 1e-6 * float(v.norm()), (k, err / float(v.norm()))


def _flagship_cfg(preset: str, dtype: str):
    cfg = PRETRAIN_PRESETS[preset]
    extra = {"moco_k": 16} if "moco" in preset else {}
    return cfg.replace(
        data=dataclasses.replace(cfg.data, seq_len=T, img_dim=S,
                                 scale_hw=(40, 36)),
        model=dataclasses.replace(cfg.model, dtype=dtype, **extra),
        optim=dataclasses.replace(cfg.optim, batch_size=4))


PRESETS = ("paper_table1_k400", "paper_table2_moco_r21d")


def _state(task) -> dict:
    return {k: v.detach().clone() for k, v in task.model.state_dict().items()
            if v.dtype.is_floating_point}


@pytest.mark.parametrize("preset", PRESETS)
def test_train_step_in_float32_counts_no_nchw_convolution(preset):
    """One step of the trainer's own ``make_train_step`` in float32 on
    synthetic frames, the backbone's input in channels-last memory: no
    convolution of the step sees NCDHW, and the losses and running
    statistics agree with the NCDHW step within 1e-5."""
    cfg = _flagship_cfg(preset, "float32")
    torch.manual_seed(0)
    state0 = pretrain.build_task(cfg).model.state_dict()
    H0, W0 = cfg.data.scale_hw
    frames = torch.randint(0, 256, (4, 3 * T, H0, W0, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    runs = []
    for layout in (False, True):
        spans.reset()
        task = pretrain.build_task(cfg)
        task.model.load_state_dict(state0)
        task.model.train()
        optimizer, scheduler = pretrain.make_optimizer(
            cfg, task.parameters(), 10)
        step = pretrain.make_train_step(task, optimizer, scheduler,
                                        pretrain.aug_config(cfg))
        with _channels_last(task.model, keep_conv_outputs=False) if layout \
                else contextlib.nullcontext():
            metrics = step(frames, torch.Generator().manual_seed(3))
        counts = spans.steps()[-1]["counts"]
        runs.append((counts.get("nchw_convs", 0),
                     {k: float(v) for k, v in metrics.items()},
                     {k: v for k, v in _state(task).items()
                      if "running" in k}))
    spans.reset()
    (n_nchw, want_loss, want_stats), (n_cl, got_loss, got_stats) = runs
    assert n_nchw > 0 and n_cl == 0
    for k, v in want_loss.items():
        assert got_loss[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    for k, v in want_stats.items():
        assert _rel(got_stats[k], v) <= 1e-5, k


@pytest.mark.parametrize("preset", PRESETS)
def test_train_step_in_float64_agrees_in_either_layout(preset):
    """The task's forward and backward with its backbones in float64 (the
    heads and losses stay float32, as the JAX package keeps them) on one
    block, segment permutation and shuffle: losses, every gradient, the
    running statistics, and MoCo's key encoder, queues and pointer."""
    cfg = _flagship_cfg(preset, "float32")
    torch.manual_seed(0)
    state0 = pretrain.build_task(cfg).model.state_dict()
    g = torch.Generator().manual_seed(7)
    block = torch.randn((4, 3, T, S, S, 3), generator=g, dtype=torch.float64)
    perm = torch.stack([torch.randperm(2, generator=g) for _ in range(4)])
    runs = []
    for layout in (False, True):
        task = pretrain.build_task(cfg)
        task.model.load_state_dict(state0)
        task.model.train()
        for m in task.model.modules():
            if isinstance(m, backbones.R2Plus1DNet):
                m.double()
        with _channels_last(task.model, keep_conv_outputs=True) if layout \
                else contextlib.nullcontext():
            ret = task.forward(block, perm=perm,
                               generator=torch.Generator().manual_seed(8))
            total_loss(ret).backward()
        runs.append({**{f"loss.{k}": v.detach() for k, v in ret.items()
                        if "loss" in k},
                     **{f"grad.{k}": p.grad.detach()
                        for k, p in task.model.named_parameters()
                        if p.grad is not None},
                     **{f"state.{k}": v for k, v in _state(task).items()}})
    want, got = runs
    assert set(got) == set(want)
    assert sum(k.startswith("grad.backbone") or
               k.startswith("grad.encoder_q.backbone") for k in want) > 20
    for k, v in want.items():
        assert _rel(got[k], v) <= 1e-6, (k, _rel(got[k], v))
